"""Training slice of the port: simulated-prompt forward, losses, AdamW step."""
