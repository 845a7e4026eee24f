from .lendist import LenDist
from .rspd import RSPD
from .profile import Profile, QProfile
from .qualdist import QualDist
from .noise import NoiseProfile, NoiseQProfile
from .orientation import Orientation
from .spec import ModelSpec
from .generative import GenerativeModel

__all__ = [
    "LenDist",
    "RSPD",
    "Profile",
    "QProfile",
    "QualDist",
    "NoiseProfile",
    "NoiseQProfile",
    "Orientation",
    "ModelSpec",
    "GenerativeModel",
]
