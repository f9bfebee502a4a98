"""Problem generators and hierarchy checkpoints."""
