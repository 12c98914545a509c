"""On-card checks of the CUDA kernels against their plain versions, at the
small parity shapes. They need a CUDA card and skip without one; the card's
full check is ``python3 chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import transforms as T
from repro_torch.core.descriptor import build_plain, new_outputs
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.matmul import matmul_desc

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cases(dev):
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    yield matmul_desc(96, 64, 48, bm=16, bk=32, bn=16), (t(96, 64), t(64, 48))
    yield (flash_attention_desc(6, 32, 40, 8, 2, causal=True, q_offset=8,
                                bq=8, bk=8), (t(6, 32, 8), t(3, 40, 8),
                                              t(3, 40, 8)))


@pytest.mark.parametrize("form", ["plain", "sliced", "persistent"])
def test_kernel_matches_plain_version(cuda, form):
    for desc, args in _cases(cuda):
        fam = desc.kernel
        want = new_outputs(desc, cuda, zero=True)
        fam.plain_version(desc, args, want)
        before = dict(fam.launches)
        if form == "plain":
            got = list(build_plain(desc)(*args))
        elif form == "sliced":
            got = new_outputs(desc, cuda, zero=True)
            for off, ln in T.slice_plan(desc, 3):
                got = list(T.build_sliced(desc, off, ln)(got, *args))
        else:
            pre = T.make_preemptible(desc, 5)
            got, start = new_outputs(desc, cuda, zero=True), 0
            while start < pre.total_tasks:
                got, done = pre(got, start, 2, *args)
                ref_done = fam.persistent_version(
                    desc, pre.num_workers, start, 2, args,
                    new_outputs(desc, cuda, zero=True))
                assert torch.equal(done.cpu(), ref_done.cpu())
                start = pre.watermark(start, 2)
        torch.cuda.synchronize()
        assert fam.launches[f"{fam.name}_{form}"] > before[
            f"{fam.name}_{form}"]
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
