"""Plain float32 PyTorch reference of HRRadarPose (no code of the program)."""
