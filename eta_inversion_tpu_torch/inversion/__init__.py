"""Inverters: the engine (diffinv) and eta inversion."""
