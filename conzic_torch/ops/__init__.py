"""Attention masking helpers."""
