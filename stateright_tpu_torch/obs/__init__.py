"""Observability pieces the port's engines need: the metrics registry."""
