"""Kernels that start in the device views of the program's
``sg2.synthesis`` spans (StyleGAN2's synthesis, FIR included), a
request: what the non-fused modulation costs in launches. None without
those spans. Moves sample_faces_per_s."""

from benchmark.lib.sg2_flops import view_kernels


def read(outcome):
    return view_kernels(outcome, "sg2.synthesis")
