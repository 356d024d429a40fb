"""Federated runtime of the port: the star and gossip syncs
(``topology``), the round engines (``round``), the update codecs and
wire-byte accounting (``compress``), the client population bank and its
async rounds (``population``) and the cohort samplers (``sampling``)."""
