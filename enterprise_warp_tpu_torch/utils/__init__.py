"""Small shared utilities of the torch port."""
