"""Layers, the transformer (dense, MoE), Mamba2 and hybrid models, and family dispatch."""
