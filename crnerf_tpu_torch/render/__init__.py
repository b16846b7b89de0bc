"""Renderer, system, inference front end and camera paths."""
