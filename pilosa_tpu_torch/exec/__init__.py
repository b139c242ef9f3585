"""Query planning and execution over the device plane mirrors."""
