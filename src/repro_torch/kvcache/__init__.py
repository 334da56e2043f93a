"""Paged KV pool: block manager, pool and zero-copy view."""
