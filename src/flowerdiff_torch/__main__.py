"""`python -m flowerdiff_torch ...`: the command line (cli.py)."""
from flowerdiff_torch.cli import main

if __name__ == "__main__":
    main()
