"""Observability and wire-volume helpers."""
