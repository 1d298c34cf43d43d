"""Parameter trees, text-embedding caches and video export."""
