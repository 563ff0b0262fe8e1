"""StyleGAN2's synthesis against the bound of its convs in the traced
sampler requests, in %: the modulated 3x3 convs, the up-convs at their
input positions and the ToRGBs at the request's batch
(lib/sg2_flops.py), over the device time of the program's
``sg2.synthesis`` views (the whole network: convs, modulation,
demodulation, noise, activations, the FIR). None without those spans.
Moves sample_faces_per_s."""

from benchmark.lib.sg2_flops import view_share


def read(outcome):
    return view_share(outcome, "synthesis_bound_s", "sg2.synthesis")
