"""Tokenizers."""
