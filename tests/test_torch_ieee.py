"""df3d_torch.core.ieee: square roots rounded correctly on the CPU, which
torch's f32 `sqrt` is not on some hosts. Each root of a million seeded f32
inputs in [0, 100) is held exactly against numpy's f32 `sqrt` (IEEE 754's
correctly rounded root); the share of inputs on which torch's own CPU
`sqrt` is off is printed (an ulp off on ~17% of them on an AMD EPYC with
AVX-512, none on hosts whose torch rounds correctly)."""

import numpy as np
import pytest
import torch

from df3d_torch.core import ieee
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fn", ["sqrt", "foreach_sqrt"])
def test_correctly_rounded_on_the_cpu(fn):
    x = np.random.RandomState(0).rand(1_000_000).astype(np.float32) * 100
    want = np.sqrt(x)
    t = torch.from_numpy(x)
    got = (ieee.sqrt(t) if fn == "sqrt" else ieee.foreach_sqrt([t])[0])
    np.testing.assert_array_equal(got.numpy(), want)
    off = (torch.sqrt(t).numpy() != want).mean()
    print(f"torch.sqrt on this CPU ({torch.backends.cpu.get_cpu_capability()})"
          f": {off:.4f} of the inputs off the correctly rounded root")
