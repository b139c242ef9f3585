"""HTTP front end (JSON only)."""
