"""End-to-end serving driver: batched request serving of an assigned
architecture, always its reduced variant — the twin of
``examples/serve_llm.py`` on the port.

  PYTHONPATH=src python -m repro_torch.examples.serve_llm \\
      --arch smollm-135m --batch 8 [--device cpu]
"""
import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv = argv + ["--reduced"]
    return serve.main(argv)


if __name__ == "__main__":
    main()
