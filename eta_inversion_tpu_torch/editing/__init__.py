"""Editors and the controllers they drive the engine with."""
