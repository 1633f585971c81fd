"""Launch-side analysis: the step's roofline model (``launch/roofline.py``)."""
