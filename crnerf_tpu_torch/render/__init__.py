"""Renderer, system and inference front end of the serving path."""
