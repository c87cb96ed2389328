"""Entry points that run the port: the recommendation server."""
