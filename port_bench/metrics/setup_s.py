"""setup_s: seconds from the process's start until the window opens
(imports, the kernel library's build or load, the checkpoint, the
wrappers and the warm-up of the cell's own shapes)."""


def read(record):
    return record["setup_s"]
