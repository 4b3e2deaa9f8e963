"""Model merging and the command line."""
