"""In-code bibliography (reference: pointmatcher/Bibliography.{h,cpp}).

The port's own copy of ``libpointmatcher_tpu.bibliography``, the same
entries and the same rendering. Module description strings embed
``\\cite{key}`` markers; ``list_modules`` renders them as [n] with a
bibliography section, in text / websiteRoster / bibtex styles like the
reference's CMS modes."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["BIBLIOGRAPHY", "process_citations", "bibtex_entry", "text_entry"]

BIBLIOGRAPHY: Dict[str, Dict[str, str]] = {
    "Besl1992Point2Point": {
        "type": "article",
        "title": "A Method for Registration of 3-D Shapes",
        "author": "Besl, P.J. and McKay, H.D.",
        "journal": "Pattern Analysis and Machine Intelligence, IEEE Transactions on",
        "year": "1992",
        "volume": "14", "number": "2", "pages": "239--256",
    },
    "Chen1991Point2Plane": {
        "type": "inproceedings",
        "title": "Object modeling by registration of multiple range images",
        "author": "Chen, Y. and Medioni, G.",
        "booktitle": "Robotics and Automation, 1991. Proceedings., 1991 IEEE International Conference on",
        "year": "1991", "pages": "2724--2729",
    },
    "Rusinkiewicz2001": {
        "type": "inproceedings",
        "title": "Efficient variants of the ICP algorithm",
        "author": "Rusinkiewicz, S. and Levoy, M.",
        "booktitle": "3-D Digital Imaging and Modeling, 2001. Proceedings. Third International Conference on",
        "year": "2001", "pages": "145--152",
    },
    "Gelfand2003": {
        "type": "inproceedings",
        "title": "Geometrically stable sampling for the ICP algorithm",
        "author": "Gelfand, N. and Ikemoto, L. and Rusinkiewicz, S. and Levoy, M.",
        "booktitle": "3-D Digital Imaging and Modeling, 2003. 3DIM 2003. Proceedings. Fourth International Conference on",
        "year": "2003", "pages": "260--267",
    },
    "Phillips2007": {
        "type": "inproceedings",
        "title": "Outlier robust ICP for minimizing fractional RMSD",
        "author": "Phillips, J.M. and Liu, R. and Tomasi, C.",
        "booktitle": "3-D Digital Imaging and Modeling, 2007. 3DIM '07. Sixth International Conference on",
        "year": "2007", "pages": "427--434",
    },
    "Censi2007ICPCovariance": {
        "type": "inproceedings",
        "title": "An accurate closed-form estimate of ICP's covariance",
        "author": "Censi, A.",
        "booktitle": "Robotics and Automation, 2007 IEEE International Conference on",
        "year": "2007", "pages": "3167--3172",
    },
    "Pomerleau2012Noise": {
        "type": "inproceedings",
        "title": "Noise characterization of depth sensors for surface inspections",
        "author": "Pomerleau, F. and Breitenmoser, A. and Liu, M. and Colas, F. and Siegwart, R.",
        "booktitle": "Applied Robotics for the Power Industry (CARPI), 2012 2nd International Conference on",
        "year": "2012", "pages": "16--21",
    },
    "RobustWeightFcts": {
        "type": "article",
        "title": "Robust regression using iteratively reweighted least-squares",
        "author": "Holland, P.W. and Welsch, R.E.",
        "journal": "Communications in Statistics - Theory and Methods",
        "year": "1977", "volume": "6", "number": "9", "pages": "813--827",
    },
    "Bergstrom2014": {
        "type": "article",
        "title": "Robust registration of point sets using iteratively reweighted least squares",
        "author": "Bergstr{\\\"o}m, P. and Edlund, O.",
        "journal": "Computational Optimization and Applications",
        "year": "2014", "volume": "58", "number": "3", "pages": "543--561",
    },
    "Bosse2013Gestalt": {
        "type": "article",
        "title": "Place recognition using keypoint voting in large 3D lidar datasets",
        "author": "Bosse, M. and Zlot, R.",
        "journal": "Robotics and Automation (ICRA), 2013 IEEE International Conference on",
        "year": "2013",
    },
    "Laconte2019SensorBias": {
        "type": "inproceedings",
        "title": "Lidar Measurement Bias Estimation via Return Waveform Modelling in a Context of 3D Mapping",
        "author": "Laconte, J. and Deschênes, S.-P. and Labussière, M. and Pomerleau, F.",
        "booktitle": "2019 International Conference on Robotics and Automation (ICRA)",
        "year": "2019", "pages": "8100--8106",
    },
    "Pomerleau2012Challenging": {
        "type": "article",
        "title": "Challenging data sets for point cloud registration algorithms",
        "author": "Pomerleau, F. and Liu, M. and Colas, F. and Siegwart, R.",
        "journal": "The International Journal of Robotics Research",
        "year": "2012", "volume": "31", "number": "14", "pages": "1705--1711",
    },
    "Pomerleau2013Comparing": {
        "type": "article",
        "title": "Comparing ICP variants on real-world data sets",
        "author": "Pomerleau, F. and Colas, F. and Siegwart, R. and Magnenat, S.",
        "journal": "Autonomous Robots",
        "year": "2013", "volume": "34", "number": "3", "pages": "133--148",
    },
    "Pavlov2017AAICP": {
        "type": "inproceedings",
        "title": "AA-ICP: Iterative Closest Point with Anderson Acceleration",
        "author": "Pavlov, A.L. and Ovchinnikov, G.V. and Derbyshev, D.Y. and Tsetserukou, D. and Oseledets, I.V.",
        "booktitle": "2018 IEEE International Conference on Robotics and Automation (ICRA)",
        "year": "2018", "pages": "3407--3412",
    },
    "Masuda1996Random": {
        "type": "article",
        "title": "Registration and integration of multiple range images for 3-D model construction",
        "author": "Masuda, T. and Sakaue, K. and Yokoya, N.",
        "journal": "Pattern Recognition, 1996., Proceedings of the 13th International Conference on",
        "year": "1996", "volume": "1", "pages": "879--883",
    },
    "Diebel2004Median": {
        "type": "inproceedings",
        "title": "Simultaneous Localization and Mapping with Active Stereo Vision",
        "author": "Diebel, J. and Reutersward, K. and Thrun, S. and Davis, J. and Gupta, R.",
        "booktitle": "IROS",
        "year": "2004", "pages": "3436--3443",
    },
}

_CITE_RE = re.compile(r"\\cite\{([^}]+)\}")


def process_citations(text: str, style: str = "normal") -> Tuple[str, List[str]]:
    """Replace \\cite{key} with [n] markers; → (text, cited keys in order)."""
    keys: List[str] = []

    def sub(m):
        key = m.group(1)
        if key not in keys:
            keys.append(key)
        n = keys.index(key) + 1
        return f"[{n}]"

    return _CITE_RE.sub(sub, text), keys


def bibtex_entry(key: str) -> str:
    e = BIBLIOGRAPHY.get(key)
    if e is None:
        return f"% unknown citation key {key}\n"
    typ = e.get("type", "article")
    fields = "\n".join(
        f"  {k} = {{{v}}}," for k, v in e.items() if k != "type"
    )
    return f"@{typ}{{{key},\n{fields}\n}}\n"


def text_entry(key: str) -> str:
    e = BIBLIOGRAPHY.get(key)
    if e is None:
        return f"(unknown reference {key})"
    parts = [e.get("author", "?"), e.get("title", "?")]
    venue = e.get("journal") or e.get("booktitle")
    if venue:
        parts.append(venue)
    parts.append(e.get("year", "?"))
    return ". ".join(parts)
