"""Config helpers."""
