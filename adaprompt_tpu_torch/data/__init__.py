"""Training data: subject folders and prompt sets."""
