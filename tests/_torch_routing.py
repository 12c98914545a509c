"""A guard for the tests that hold the port's MoE routing against the JAX
package's: ``clear_routing()`` records, for every routing call of the
port's ``moe.top_k`` inside it, the gap between the K-th and the
(K+1)-th router probability, and fails if the smallest gap is not above
``MIN_GAP``. A test whose data put two experts within rounding of each
other would then fail as such, instead of as a parity mismatch that comes
and goes with the order of the router's sums."""
import contextlib

import torch

from repro_torch.models import moe

# the two packages' f32 router probabilities differ by ~1e-7 on the
# reduced configs; 1e-5 leaves a hundredfold margin
MIN_GAP = 1e-5


@contextlib.contextmanager
def clear_routing(min_gap: float = MIN_GAP):
    gaps = []
    top_k = moe.top_k

    def recording(probs, k):
        v = torch.sort(probs.detach(), dim=-1, descending=True).values
        gaps.append(float((v[..., k - 1] - v[..., k]).min()))
        return top_k(probs, k)

    moe.top_k = recording
    try:
        yield gaps
    finally:
        moe.top_k = top_k
    assert gaps, "no routing call inside clear_routing()"
    assert min(gaps) > min_gap, (
        f"a near-tie in the routing: the K-th and (K+1)-th router "
        f"probabilities lie {min(gaps):.2e} apart (<= {min_gap:g})")
