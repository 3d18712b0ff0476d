"""Meshes of devices and the rules that place the HDC state on them."""
