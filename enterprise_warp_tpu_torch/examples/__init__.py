"""Example plugins for the port (the custom-models contract)."""
