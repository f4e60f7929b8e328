"""``python -m binf_tpu_torch``: the command line (``cli.py``)."""

from binf_tpu_torch.cli import main

# guarded, so that importing every module of the package runs nothing
if __name__ == "__main__":
    main()
