"""Host utilities for the port: numpy SE(3), logging, phase timing and
diagnostic colors."""
