"""device_program.seed_ms_per_kread (ms/kread): the device program's
seeding stage, Aligner.stage_ms["seed"] plus esc_stage_ms["seed"] (the
port's stage clock, each stage ended by a sync: on in the traced run
only), per thousand reads of the window. Layer: pipeline.device_align,
align/seeding.py."""


def read(t):
    if "seed" not in t.stage_ms or not t.work:
        return None
    return (t.stage_ms["seed"] + t.esc_stage_ms.get("seed", 0.0)) \
        / t.kreads
