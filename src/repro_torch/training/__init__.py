"""Tokenizer of the serving path."""
