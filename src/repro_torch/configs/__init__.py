"""Model configurations (the port registers tinyllama-1.1b only)."""
