"""Graph containers and generators."""
