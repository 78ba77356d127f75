"""The streaming engine and its request scheduler."""
