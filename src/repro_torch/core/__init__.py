"""Topologies, the flat gossip bus, mixing backends and the train step."""
