"""Host-side data for the serving path: preprocessing and synthetic scenes."""
