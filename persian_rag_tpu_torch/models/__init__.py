"""Encoder stack: tokenizer, transformer, pooling, sentence encoder."""
