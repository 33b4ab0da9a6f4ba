"""Device milliseconds of the staging copies (`Trainer.stage_batch`'s
host-to-device copies) per staged batch in the traced slice."""


def read(rec):
    batches = rec.counts.get("steps_in_slice")
    if rec.profile is None or not batches:
        return None
    seconds, copies = rec.profile.op_seconds(
        lambda name: name.startswith("Memcpy HtoD"))
    return 1e3 * seconds / batches if copies else None
