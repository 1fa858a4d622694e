from gsasr_torch.models.edsr import EDSRNOUP
from gsasr_torch.models.fea2gs import Fea2GS
from gsasr_torch.models.fea2gs_rope import Fea2GSRopeAMP

__all__ = ["EDSRNOUP", "Fea2GS", "Fea2GSRopeAMP"]
