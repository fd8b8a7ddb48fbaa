"""The paper's own experimental config (own copy of
``repro.configs.paper_lr``; Sec 6): feature-partitioned linear regression —
synthetic (960 features x 5000 examples) and the real-dataset shape
(150,360 features x 16,087 examples; Kogan et al. 2009 proxy)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperLRConfig:
    n_features: int = 960
    n_examples: int = 5000
    lr: float = 0.05
    n_iters: int = 100
    mode: str = "gd"            # gd | sgd | minibatch
    batch_size: int = 100
    seed: int = 0


def synthetic() -> PaperLRConfig:
    return PaperLRConfig()


def real_shape() -> PaperLRConfig:
    """The Kogan et al. dataset is not redistributable; its SHAPE is
    reproduced with a sparse synthetic equivalent
    (``data.synthetic.sparse_regression_dataset``)."""
    return PaperLRConfig(n_features=150_360, n_examples=16_087,
                         mode="sgd", n_iters=400)
