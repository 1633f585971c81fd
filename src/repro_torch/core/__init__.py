"""Int8 compression containers, quantization and the recipe pipeline."""
