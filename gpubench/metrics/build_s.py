"""build_s (s): the harness's clock around the trainer's build, from the
host data to a trainer ready to run: the dense head and sorted tails
(core/dataset.py::to_hybrid), a streamed job's split_blocks and
page-locking (StreamingAdmmTrainer.__init__), the copies to the card."""


def read(run):
    return run["build_s"]
