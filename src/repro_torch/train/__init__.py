"""Serving step factories of the LM scaffolding (`serve`)."""
