"""`python -m sobfu_tpu_torch` — the reconstruction CLI (see sobfu_tpu_torch.cli)."""

from sobfu_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
