"""Subject metadata parsing.

The port's own copy of `adaprompt_tpu/eval/subject_info.py` (the
reference's parse_subject_file, evaluation/eval_utils.py): read the
fish-shell `set -g <var> <values...>` metadata files of a subject set
(names, class tokens, cls-delta strings, broad classes, are_faces flags),
and apply them to the subjects of `data/dataset.scan_subject_folders`.
"""

from __future__ import annotations

import re
import shlex


def _split(value: str):
    # fish quoting follows shell-like rules; shlex handles quoted groups
    return shlex.split(value)


def parse_subject_file(path: str):
    """-> (subj_info dict, subj2attr dict) with the reference's semantics."""
    subj_info: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            mat = re.search(r"^set -g ([a-zA-Z_]+)\s+(\S.*)", line)
            if mat is None:
                continue
            var, raw = mat.group(1), mat.group(2)
            parts = _split(raw)
            if re.match("broad_classes|are_faces|maxiters", var):
                values = [int(s) for s in parts]
            elif var == "all_init_word_weights":
                values = [[float(x) for x in _split(p)] for p in parts]
            elif var == "sel_set":
                values = [int(s) - 1 for s in parts]
            else:
                values = parts
            # variable references: set -g cls_strings $cls_delta_strings
            if len(values) == 1 and isinstance(values[0], str) and values[0].startswith("$"):
                values = subj_info.get(values[0][1:], values)
            subj_info[var] = values

    for required in ("subjects", "cls_delta_strings"):
        if required not in subj_info:
            raise ValueError(f"{required} not defined in {path}")

    n = len(subj_info["subjects"])
    subj_info.setdefault("broad_classes", [1] * n)
    subj_info.setdefault("sel_set", list(range(n)))

    subj2attr: dict = {}
    for var in ("class_names", "cls_delta_strings", "all_init_word_weights",
                "bg_init_strings", "broad_classes", "are_faces"):
        if var in subj_info:
            vals = subj_info[var]
            if len(vals) != n:
                raise ValueError(f"{var}: {len(vals)} values for {n} subjects")
            subj2attr[var] = dict(zip(subj_info["subjects"], vals))
    return subj_info, subj2attr


def apply_subject_info(subjects, subj2attr):
    """Annotate `data/dataset.SubjectInfo` objects with parsed metadata."""
    for s in subjects:
        if "cls_delta_strings" in subj2attr and s.name in subj2attr["cls_delta_strings"]:
            s.cls_delta_string = subj2attr["cls_delta_strings"][s.name]
        if "broad_classes" in subj2attr and s.name in subj2attr["broad_classes"]:
            s.broad_class = subj2attr["broad_classes"][s.name]
        if "are_faces" in subj2attr and s.name in subj2attr["are_faces"]:
            s.is_face = bool(subj2attr["are_faces"][s.name])
    return subjects
