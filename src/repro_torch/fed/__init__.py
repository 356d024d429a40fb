"""Federated runtime of the port: the star sync (``topology``), the round
engines (``round``), the update codecs and wire-byte accounting
(``compress``), the client population bank (``population``) and the cohort
samplers (``sampling``)."""
