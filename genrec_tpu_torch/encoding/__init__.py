"""Text embeddings of the port: the deterministic hashing embedding only."""
