"""AdaFBiO's core math: bilevel problems, the Eq. 15 Neumann hypergradient,
the adaptive matrices, Algorithm 1's steps and the Table-1 baselines. Every
per-step function here works on client-stacked states (a leading M axis)."""
