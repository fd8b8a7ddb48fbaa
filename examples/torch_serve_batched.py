"""Static-batch serving on the PyTorch port (the counterpart of
``examples/serve_batched.py``): the drain-the-batch baseline.

One code path with the continuous-batching CLI: this forwards to
``repro_torch.launch.serve`` with ``--smoke --static``, the same engine and
paged cache with admission barriers turned back on (a new wave only
starts once every slot has drained):

    PYTHONPATH=src python examples/torch_serve_batched.py \\
        --arch llama3.2-1b --device cpu

Every other flag passes straight through to the CLI (``--rate``,
``--batch``, ``--device``, ...).  The default arch is the JAX example's,
rwkv6-1.6b, which the engine refuses as the JAX engine fails on it
(attention-free: no page class); give ``--arch`` to serve.
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv = ["--arch", "rwkv6-1.6b"] + argv
    if "--smoke" not in argv:
        argv.append("--smoke")
    return serve_main(argv + ["--static"])


if __name__ == "__main__":
    main()
