"""Host-side helpers: directories, JSON, pickle and numpy files."""
