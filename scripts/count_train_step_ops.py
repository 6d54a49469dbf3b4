"""Count the PyTorch operations one training step of the direct emulator
dispatches (``tpu21cmvae_torch.train.loop._train_step``: forward, loss,
backward, Keras Adam), at the flagship widths on 256 rows.

The count does not depend on the device: each non-view operation is one
or two kernel launches on a CUDA card, which is what makes the training
loop host-bound there (PERF.md §5). Runs on the CPU in a few seconds:

    python3 scripts/count_train_step_ops.py
"""

import collections
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu21cmvae_torch.data.synthetic import synthetic_dataset  # noqa: E402
from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: E402
from tpu21cmvae_torch.ops.transforms import par_transform, preproc  # noqa: E402
from tpu21cmvae_torch.train import loop  # noqa: E402
from tpu21cmvae_torch.train.adam import adam_init  # noqa: E402
from tpu21cmvae_torch.utils.config import DIRECT_TRAIN_DEFAULT  # noqa: E402

# operations that return a view or metadata and launch nothing
VIEWS = {"view", "t", "transpose", "slice", "select", "unsqueeze", "expand", "squeeze",
         "as_strided", "detach", "alias", "_unsafe_view", "reshape", "permute"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def main():
    data = synthetic_dataset(n_train=256, n_val=16, n_test=16, seed=0)
    model = DirectEmulator(data, device="cpu", seed=0)

    def rows(a):
        return torch.tensor(a, dtype=torch.float32)

    x = par_transform(rows(data.par_train), model.normalizer)
    y = preproc(rows(data.signal_train), model.normalizer)
    leaves = loop._trainable(model.params)
    state = adam_init(model.params)
    loss_fn = model.loss_fn()
    loop._train_step(model.params, leaves, loss_fn, x, y, state, 0.01, DIRECT_TRAIN_DEFAULT)
    with Count() as count:
        loop._train_step(model.params, leaves, loss_fn, x, y, state, 0.01, DIRECT_TRAIN_DEFAULT)
    compute = {k: v for k, v in count.ops.items() if k not in VIEWS}
    print(json.dumps({"operations": sum(count.ops.values()), "non_view": sum(compute.values()),
                      "by_name": dict(sorted(compute.items(), key=lambda kv: -kv[1]))}))


if __name__ == "__main__":
    main()
