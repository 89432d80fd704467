"""Batched proof verification on the card (`BatchVerifier`)."""
