"""Problem classes (BoxQP)."""
