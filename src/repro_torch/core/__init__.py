"""AdaFBiO's core math: bilevel problems, the Eq. 15 Neumann hypergradient,
the adaptive matrices, Algorithm 1's steps, the Table-1 baselines and the
consensus metrics. Every per-step function here works on client-stacked
states (a leading M axis)."""
