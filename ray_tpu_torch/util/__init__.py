"""Runtime checks for the port's hot paths."""
