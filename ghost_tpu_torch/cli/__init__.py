"""Entry-point CLIs, mirroring `ghost_tpu/cli` (reference script parity)."""


def str2bool(v) -> bool:
    """Robust boolean flag parsing for the extra flags.

    The reference's own flags use argparse `type=bool` (every non-empty
    string is True — a known wart kept only on flag-for-flag parity
    flags); the extra flags parse '0/false/no/off/empty' as False so
    `--bf16 False` does what it says.
    """
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() not in ("", "0", "false", "no", "off", "f",
                                          "n")
