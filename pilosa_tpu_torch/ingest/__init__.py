"""Write-path helpers: the device delta-scatter queue fold."""
