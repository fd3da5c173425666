"""Retrieval front end over the encoder and the dense index."""
