from gsasr_torch.models.edsr import EDSRNOUP
from gsasr_torch.models.fea2gs import Fea2GS
from gsasr_torch.models.fea2gs_rope import Fea2GSRopeAMP
from gsasr_torch.models.hat import HATNOUP
from gsasr_torch.models.hat_paper import HATNOUPPaper
from gsasr_torch.models.rdn import RDNNOUP
from gsasr_torch.models.swinir import SwinIRNOUP

__all__ = ["EDSRNOUP", "Fea2GS", "Fea2GSRopeAMP", "HATNOUP", "HATNOUPPaper",
           "RDNNOUP", "SwinIRNOUP"]
