"""Engine construction."""
