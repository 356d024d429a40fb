"""Deterministic synthetic federated LM data (non-iid across clients), as in
``src/repro/data/synthetic.py``.

Each client m draws tokens from a categorical law whose unigram
distribution is a client-specific permutation of a Zipf law, so clients are
statistically heterogeneous (Assumption 7's δ > 0), while batches are pure
functions of (client, step, slot): a restarted run sees identical data.

Two heterogeneity models, with the reference's host-side logic:

  * permutation (default): client unigrams are Zipf laws under
    client-specific vocabulary permutations, mixed by ``heterogeneity`` in
    [0, 1];
  * Dirichlet (``dirichlet_alpha``): client unigrams are rows of
    Dirichlet class priors over the vocabulary (small alpha, strong skew).

The random draws are inputs: a draw source gives the permutations, the
Dirichlet priors, the token draws and the modality stubs' normal draws.
:class:`TorchLMDraws` draws them with ``torch.Generator``s seeded from
(seed, stream, client, step, slot); the parity tests hand in the
reference's draws, exported through numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.data.partition import dirichlet_class_priors

# seed salts of the streams, the reference's PRNGKey constants
_PERM_SALT, _TOKEN_SALT, _STUB_SALT = 7, 3, 11


@dataclasses.dataclass(frozen=True)
class TorchLMDraws:
    """The draw source of a standalone run: every draw from a generator on
    ``device`` seeded by (seed, salt, ...)."""
    seed: int = 0
    device: Any = "cpu"

    def permutation(self, client: int, vocab: int) -> torch.Tensor:
        g = devices.generator(self.device, self.seed, _PERM_SALT, client)
        return torch.randperm(vocab, generator=g, device=self.device)

    def class_priors(self, n_clients: int, vocab: int,
                     alpha: float) -> torch.Tensor:
        return dirichlet_class_priors(
            devices.mix_seed(self.seed, _PERM_SALT), n_clients, vocab,
            alpha).to(self.device)

    def categorical(self, client: int, step: int, slot: int,
                    logits: torch.Tensor, shape) -> torch.Tensor:
        # drawn on the host, then moved: on a CUDA device
        # ``torch.multinomial`` drew other tokens from one run to the next
        # with the same generator seed (an H100), and a run must be a
        # function of its seed
        g = devices.generator("cpu", self.seed, _TOKEN_SALT, client, step,
                              slot)
        probs = torch.softmax(logits.cpu(), dim=-1)
        n = math.prod(shape)
        draw = torch.multinomial(probs, n, replacement=True, generator=g)
        return draw.reshape(tuple(shape)).to(torch.int32).to(self.device)

    def normal(self, stream: int, client: int, shape) -> torch.Tensor:
        g = devices.generator(self.device, self.seed, _STUB_SALT, stream,
                              client)
        return torch.randn(tuple(shape), generator=g, device=self.device)


@dataclasses.dataclass(frozen=True)
class FederatedLMData:
    vocab: int
    n_clients: int
    zipf_a: float = 1.2
    heterogeneity: float = 1.0    # 0 = iid clients, 1 = fully permuted unigrams
    # Dirichlet label-skew unigrams (overrides the permutation model)
    dirichlet_alpha: Optional[float] = None
    draws: Any = dataclasses.field(default_factory=TorchLMDraws)
    # per-client logits, computed once per client
    _cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

    def client_logits(self, client: int) -> torch.Tensor:
        """Client ``client``'s [vocab] unigram log-probabilities (up to a
        constant)."""
        if client not in self._cache:
            if self.dirichlet_alpha is not None:
                if "priors" not in self._cache:
                    self._cache["priors"] = self.draws.class_priors(
                        self.n_clients, self.vocab, self.dirichlet_alpha)
                logits = torch.log(self._cache["priors"][client] + 1e-20)
            else:
                base = -self.zipf_a * torch.log(
                    torch.arange(1, self.vocab + 1, dtype=torch.float32))
                perm = self.draws.permutation(client, self.vocab).cpu()
                h = self.heterogeneity
                logits = (1 - h) * base + h * base[perm]
            self._cache[client] = logits
        return self._cache[client]

    def sample(self, client: int, step: int, slot: int,
               shape) -> torch.Tensor:
        """int32 tokens of ``shape`` for (client, step, slot)."""
        return self.draws.categorical(client, step, slot,
                                      self.client_logits(client), shape)


def _materialize(data: FederatedLMData, specs: Dict[str, Any], step: int,
                 clients: Sequence[int], device) -> Dict[str, torch.Tensor]:
    out = {}
    for slot_id, (name, sds) in enumerate(sorted(specs.items())):
        shape: Tuple[int, ...] = tuple(sds.shape[1:])
        if sds.dtype == torch.int32:
            rows = [data.sample(int(c), step, slot_id, shape)
                    for c in clients]
        else:
            # modality stubs keyed per global client like the token slots
            rows = [data.draws.normal(slot_id + 100 * step, int(c), shape)
                    * 0.02 for c in clients]
        out[name] = torch.stack([r.to(device) for r in rows]).to(sds.dtype)
    return out


def make_client_batch(data: FederatedLMData, cfg, specs: Dict[str, Any],
                      step: int, device="cuda") -> Dict[str, torch.Tensor]:
    """One training step's batch matching ``client_batch_specs``, on
    ``device`` (the card unless the caller passes ``device="cpu"``): token
    keys get per-client non-iid samples, modality stubs (precomputed
    frame/patch embeddings) unit-scale noise times 0.02."""
    del cfg
    device = devices.resolve(device)
    m = next(s.shape[0] for s in specs.values())
    return _materialize(data, specs, step, range(m), device)


def make_cohort_batch(data: FederatedLMData, cfg, specs: Dict[str, Any],
                      step: int, ids, device="cuda") -> Dict[str, torch.Tensor]:
    """Like :func:`make_client_batch` for a sampled cohort: ``specs`` has a
    leading [C] axis and row j holds global client ``ids[j]``'s data."""
    del cfg
    device = devices.resolve(device)
    ids = ids.tolist() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    return _materialize(data, specs, step, [int(g) for g in ids], device)
