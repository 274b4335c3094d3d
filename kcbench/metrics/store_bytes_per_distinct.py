"""store_bytes_per_distinct: the count store's slots (the window's last
job's result width over all PEs, which is its store's) times 12 bytes a
slot (an int64 key and an int32 count), over the distinct k-mers it
holds."""

UNIT = "B/kmer"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "Receiver store (core/countstore.py)"
MOVES = "peak_mem_gb"


def read(run):
    if run.store is None or not run.store[2]:
        return None
    slots, per_slot, distinct = run.store
    return slots * per_slot / distinct
