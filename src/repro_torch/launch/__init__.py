"""Launch-layer pricing (roofline.py) and device meshes (mesh.py)."""
