"""Tokens of all ranks' steps completed in the window, over its seconds."""
from hvdbench import readers


def read(run):
    return readers.rows_done(run) * run["cell"].traffic["seq_len"] / \
        readers.window_s(run)
