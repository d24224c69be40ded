"""Compression core: formats, ASH transform, codecs, plans, collectives."""
