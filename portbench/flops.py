"""Model FLOPs of one image, counted on the CPU by ``torch.utils.flop_counter`` on
the plain reference at the configuration's shapes: the forward in eval
mode, or the forward, the loss and the backward in train mode (what one
image of a train step needs; the optimizer's elementwise update is not
counted). Convolutions and matrix products are counted; the elementwise
work, the sampling and the splat's masks are not."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

COUNT_BATCH = 2


def per_image(ref, pair: dict, cfg: dict, train: bool = False,
              batch_fn=None) -> float:
    """``batch_fn(n)`` gives a train batch of ``n`` on the reference's
    device (train mode only)."""
    from portbench.reference import losses

    dev = next(ref.parameters()).device
    size = cfg["image_size"]
    was = ref.training
    counter = FlopCounterMode(display=False)
    try:
        if train:
            ref.train()
            batch = batch_fn(COUNT_BATCH)
            with counter:
                out = ref(batch["img"], pair)
                loss = sum(losses.dir_losses(out, batch, cfg, pair).values())
                loss.backward()
            ref.zero_grad(set_to_none=True)
        else:
            ref.eval()
            img = torch.zeros((COUNT_BATCH, size, size, 3), device=dev)
            with counter, torch.no_grad():
                ref(img, pair)
    finally:
        ref.train(was)
    return counter.get_total_flops() / COUNT_BATCH
