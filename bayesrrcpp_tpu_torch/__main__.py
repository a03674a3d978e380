"""``python -m bayesrrcpp_tpu_torch``: the command-line interface
(``cli.py``)."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
