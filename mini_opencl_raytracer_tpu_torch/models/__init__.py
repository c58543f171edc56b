"""Scene containers and the procedural Cornell box."""
