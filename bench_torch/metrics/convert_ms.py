"""``convert_ms`` (layer: conversion): the host's conversion of a call's
CSR arrays into the device container, in ms a call: the self time of the
program's span ``tpcg.convert`` and of the ``tpcg.convert.*`` spans inside
it (RCM and its permutation, the DIA scatter); the uploads inside it are
``copy_ms``'s."""
from bench_torch.program_spans import per_call, self_s


def _convert_s(top, recs):
    return sum(self_s(r, recs) for r in recs
               if r.name == "tpcg.convert" or r.name.startswith(
                   "tpcg.convert."))


def read(ctx):
    s = per_call(ctx, _convert_s)
    return None if s is None else s * 1e3
