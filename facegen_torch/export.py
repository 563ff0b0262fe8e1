"""Generator export for serving without PyTorch (counterpart of
facegen/export.py).

``export_generator`` packs a G's parameters, batch-norm statistics and
architecture into one .npz under facegen's leaf names
(``params/00_fc/w``, ``state/04_batch_norm/mean``, ...; HWIO conv and
(in, out) dense kernels) and facegen's ``__meta__``, so that a file
written by either package serves in the other. ``NumpyGenerator`` runs
it with NumPy alone (eval mode: BN running statistics, the upsample and
the 5x5 conv composed); its forward mirrors models/gan.py:create_g with
the "nhwc" noise view.

    python -m facegen_torch.export --save logs --network adversarial --out generator.npz
"""

from __future__ import annotations

import json
import os

import numpy as np


def export_generator(g, out_path: str, scale: int, channels: int, noise_dim: int) -> str:
    """Write G's parameters and statistics (``g``: the port's G module)
    and the architecture's metadata to one .npz."""
    from facegen_torch.utils.checkpoint import module_arrays

    arrays = module_arrays(g, "params", "state")
    meta = {"scale": scale, "channels": channels, "noise_dim": noise_dim,
            "arch": "g_upsampling"}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, __meta__=json.dumps(meta), **arrays)
    return out_path


def export_from_checkpoint(save_dir: str, out_path: str, name: str = "adversarial") -> str:
    """Export straight from a training checkpoint directory; the
    architecture comes from the checkpoint's own stored config
    (models/gan.py:restore_gan)."""
    from facegen_torch.models.gan import restore_gan

    g, _, res = restore_gan(name, default_dir=save_dir, device="cpu")
    return export_generator(g, out_path, res["scale"], res["channels"], res["noise_dim"])


class NumpyGenerator:
    """Pure-NumPy forward of the exported G (eval mode)."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            self.meta = json.loads(str(z["__meta__"]))
            self.arrays = {k: z[k] for k in z.files if k != "__meta__"}
        self.scale = self.meta["scale"]
        self.channels = self.meta["channels"]
        self.noise_dim = self.meta["noise_dim"]
        self.s0 = 4 if self.scale == 16 else self.scale // 4

    def _p(self, key):
        return self.arrays["params/" + key]

    def _s(self, key):
        return self.arrays["state/" + key]

    @staticmethod
    def _prelu(x, a):
        return np.maximum(x, 0) + float(a[0]) * np.minimum(x, 0)

    @staticmethod
    def _conv_same(x, w, b):
        """NHWC same-pad conv via einsum over shifted views."""
        k = w.shape[0]
        pad = (k - 1) // 2
        n, h, wd, ci = x.shape
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        out = np.zeros((n, h, wd, w.shape[-1]), np.float32)
        for dy in range(k):
            for dx in range(k):
                patch = xp[:, dy : dy + h, dx : dx + wd, :]
                out += patch @ w[dy, dx]
        return out + b

    @staticmethod
    def _upsample2(x):
        return x.repeat(2, axis=1).repeat(2, axis=2)

    def _bn(self, x, key):
        p = self._p(key + "/scale"), self._p(key + "/bias")
        mean, var = self._s(key + "/mean"), self._s(key + "/var")
        return (x - mean) / np.sqrt(var + 1e-5) * p[0] + p[1]

    def __call__(self, z: np.ndarray) -> np.ndarray:
        """z: (N, noise_dim) in [-1, 1] -> (N, scale, scale, C) in [0, 1]."""
        x = z.astype(np.float32) @ self._p("00_fc/w") + self._p("00_fc/b")
        x = x.reshape(-1, self.s0, self.s0, 128)
        x = self._prelu(x, self._p("02_prelu/a"))
        x = self._conv_same(self._upsample2(x), self._p("03_upconv1/w"),
                            self._p("03_upconv1/b"))
        x = self._bn(x, "04_batch_norm")
        x = self._prelu(x, self._p("05_prelu/a"))
        x = self._conv_same(self._upsample2(x), self._p("06_upconv2/w"),
                            self._p("06_upconv2/b"))
        x = self._bn(x, "07_batch_norm")
        x = self._prelu(x, self._p("08_prelu/a"))
        x = self._conv_same(x, self._p("09_conv_out/w"), self._p("09_conv_out/b"))
        return 1.0 / (1.0 + np.exp(-x))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="export a trained generator to npz")
    p.add_argument("--save", default="logs")
    p.add_argument("--network", default="adversarial")
    p.add_argument("--out", default="generator.npz")
    a = p.parse_args(argv)
    out = export_from_checkpoint(a.save, a.out, a.network)
    print(f"exported {out}")


if __name__ == "__main__":
    main()
