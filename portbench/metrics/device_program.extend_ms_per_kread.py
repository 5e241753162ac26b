"""device_program.extend_ms_per_kread (ms/kread): the device program's
extension stage, Aligner.stage_ms["extend"] plus
esc_stage_ms["extend"] (each stage ended by a sync: on in the traced
run only), per thousand reads of the window. Layer: align/extend.py."""


def read(t):
    if "extend" not in t.stage_ms or not t.work:
        return None
    return (t.stage_ms["extend"] + t.esc_stage_ms.get("extend", 0.0)) \
        / t.kreads
