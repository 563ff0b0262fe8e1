"""StyleGAN2's D against the bound of its convs and linear layers in the
traced sampler requests (two passes over the request's faces, a ranking
each), in %, over the device time of the program's ``infer.score``
views. None without ``sg2.*`` spans in the slice (another net's D).
Moves sample_faces_per_s."""

from benchmark.lib.sg2_flops import view_share


def read(outcome):
    return view_share(outcome, "d_bound_s", "infer.score")
