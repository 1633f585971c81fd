"""Sharding rules and single-controller collectives over a mesh."""
