"""Serving: MIPS indexes over the encoded corpus and the retrieval service."""
