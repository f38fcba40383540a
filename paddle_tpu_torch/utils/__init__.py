"""Shared host-side helpers."""
