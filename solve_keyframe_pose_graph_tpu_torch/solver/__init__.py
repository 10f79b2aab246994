"""Problem tensors for one solve and the streaming trigger engine."""
