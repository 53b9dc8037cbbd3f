"""Serving plane of the port."""
