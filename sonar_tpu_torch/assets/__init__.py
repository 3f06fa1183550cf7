"""Weight conversion and loading for the port."""
