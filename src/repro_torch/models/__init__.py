"""Dense transformer layers, model and family dispatch."""
