"""wire_gb_per_iter (GB): host-to-device bytes an iteration of a streamed
cell, the trainer's own count (StreamingAdmmTrainer.stream_wire_bytes,
after residency and the compact wire); nothing for an in-memory cell."""


def read(run):
    b = run["wire_bytes_per_iter"]
    return None if b is None else b / 1e9
