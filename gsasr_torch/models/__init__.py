from gsasr_torch.models.edsr import EDSRNOUP
from gsasr_torch.models.fea2gs import Fea2GS

__all__ = ["EDSRNOUP", "Fea2GS"]
