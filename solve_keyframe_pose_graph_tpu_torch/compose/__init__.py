"""Output assembly for the port: corrected trajectory composition,
low-latency pose serving, viz sinks, checkpoint save/load."""
