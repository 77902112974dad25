"""Where the PyTorch port's CycleGAN card-vs-CPU gradient hold
(``chip_smoke.py`` phase 21) loses precision.  From the repo's root:

    PYTHONPATH=. python tools/cyclegan_precision.py --part cpu
    PYTHONPATH=. python tools/cyclegan_precision.py --part card

``cpu``: one iteration of ``chip_smoke.py``'s CycleGAN at ngf = ndf = 16,
3 residual blocks, 64x64, float32 against float64 on the CPU, with each
run's own ReLU decisions and with the float64 run's
(``chip_smoke.relu_decisions``).  ``card`` (needs a card): the first
iteration at the published widths, every run taking the CPU oneDNN
run's ReLU decisions: the CPU with oneDNN and without it, the card with
cuDNN and without it, in float32, against the card in float64; and the
card's own decisions against the CPU's.  Each line prints the worst
share of a tensor's largest magnitude."""
import argparse
import sys

import numpy as np
import torch

import chip_smoke as cs


def worst(got, want, names=None):
    names = names or want
    e, n = max((cs.share(got[n].double(), want[n].double()), n)
               for n in names)
    return f"{e:.2e} ({n})"


def cyclegan_grads(c, start, dev, dtype, pinned, mkldnn=True, cudnn=True):
    """Step-1 gradients of one iteration from `start`'s weights, and the
    ReLU decisions it took (its own when `pinned` is None)."""
    nets = tuple(n.to(dtype) for n in cs.cyclegan_on(start, dev, c))
    opts = dict(cs.cyclegan_optimizers(nets, c), grads=[])
    images = cs.cyclegan_images(np.random.default_rng(30), c)
    prev = torch.backends.mkldnn.enabled, torch.backends.cudnn.enabled
    torch.backends.mkldnn.enabled, torch.backends.cudnn.enabled = (mkldnn,
                                                                   cudnn)
    try:
        with cs.relu_decisions(nets, pinned) as (decisions, flips):
            cs.cyclegan_iteration(nets, opts, *[
                torch.from_numpy(a).to(dev, dtype) for a in images], c=c)
    finally:
        torch.backends.mkldnn.enabled, torch.backends.cudnn.enabled = prev
    return ({n: g.cpu() for n, g in opts["grads"][0].items()}, decisions,
            flips[0])


def part_cpu():
    c = dict(cs.CYCLEGAN, ngf=16, ndf=16, blocks=3, image=64)
    start = cs.port_cyclegan(c, seed=0)
    g64, dec, _ = cyclegan_grads(c, start, "cpu", torch.float64, None)
    free, _, _ = cyclegan_grads(c, start, "cpu", torch.float32, None)
    pinned, _, flips = cyclegan_grads(c, start, "cpu", torch.float32, dec)
    print(f"CPU float32 vs float64, own decisions: {worst(free, g64)}")
    print(f"CPU float32 vs float64, float64's decisions ({flips} of its "
          f"own overridden): {worst(pinned, g64)}")


def part_card():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    c = cs.CYCLEGAN
    start = cs.port_cyclegan(c, seed=0)
    onednn, dec, _ = cyclegan_grads(c, start, "cpu", torch.float32, None)
    runs = {
        "CPU float32 without oneDNN": ("cpu", torch.float32, False, True),
        "card float32, cuDNN off": ("cuda", torch.float32, True, False),
        "card float32, cuDNN on": ("cuda", torch.float32, True, True),
        "card float64, cuDNN on": ("cuda", torch.float64, True, True)}
    grads = {"CPU float32 with oneDNN": onednn}
    for label, (dev, dtype, mkldnn, cudnn) in runs.items():
        grads[label] = cyclegan_grads(c, start, dev, dtype, dec, mkldnn,
                                      cudnn)[0]
    ref = cyclegan_grads(c, start, "cuda", torch.float64, dec, cudnn=False)
    for label, g in grads.items():
        print(f"{label} vs card float64 cuDNN off: {worst(g, ref[0])}")
    own = cyclegan_grads(c, start, "cuda", torch.float32, None)[0]
    print(f"card float32 cuDNN on, its own decisions, vs the CPU with "
          f"oneDNN: {worst(own, onednn)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("cpu", "card"), required=True)
    part = ap.parse_args().part
    if part == "card" and not torch.cuda.is_available():
        sys.exit("--part card needs a card")
    {"cpu": part_cpu, "card": part_card}[part]()
