"""Debug guards and preemption handling."""
