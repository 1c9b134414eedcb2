"""The locally-essential-tree distribution of an FmmPlan over ranks that
live on a list of devices (``let.py``)."""
