"""Federated runtime of the port: the star sync (``topology``), the round
engines (``round``) and wire-byte accounting (``compress``)."""
