"""Text data loading: CSV / TSV / LibSVM with format auto-detection; the
PyTorch port's copy of lightgbm_tpu/io.py, parsed in Python (the JAX
package's optional native parser gives the same values, each token read as
a correctly rounded double).

Counterpart of the reference Parser (src/io/parser.{cpp,hpp}) and the
file-side of DatasetLoader (src/io/dataset_loader.cpp): sniffs the format from the
first lines (Parser::CreateParser), resolves the label column, reads optional
sidecar ``<file>.weight`` / ``<file>.query`` / ``<file>.init`` files
(metadata.cpp semantics), and returns dense numpy arrays ready for binning.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .utils import log
from .utils.vfile import vexists, vopen


def _sniff_format(lines: List[str]) -> str:
    """Parser::CreateParser format detection: libsvm if 'idx:value' tokens."""
    for line in lines:
        toks = line.replace("\t", " ").split()
        if any(":" in t for t in toks[1:]):
            return "libsvm"
    if lines and "\t" in lines[0]:
        return "tsv"
    return "csv"


_MISSING_TOKENS = frozenset(("", "NA", "na", "NaN", "nan", "N/A", "null", "NULL", "None"))


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def load_text_file(
    path: str,
    has_header: bool = False,
    label_column: str = "",
    model_num_features: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[List[str]]]:
    """Returns (features [N, F], label [N] or None, feature_names or None).

    With ``model_num_features`` set (prediction path), label presence is
    detected by comparing the file's column count against the model — the
    reference Predictor's behavior for label-less prediction files.
    """
    with vopen(path) as fh:
        raw_lines = [ln.rstrip("\r\n") for ln in fh if ln.strip()]
    if not raw_lines:
        log.fatal("Data file %s is empty" % path)

    header: Optional[List[str]] = None
    first = raw_lines[0]
    sample = raw_lines[1 if has_header else 0 : 20]
    fmt = _sniff_format(sample)
    sep = "\t" if fmt == "tsv" else ","
    if fmt != "libsvm":
        # a first row is a header only if it has tokens that are neither
        # numbers nor missing-value markers (a row like "NA,1,0" is data)
        first_toks = [t.strip() for t in first.split(sep)]
        auto_header = not all(_is_number(t) or t in _MISSING_TOKENS for t in first_toks)
    else:
        auto_header = False
    use_header = has_header or auto_header
    if use_header:
        raw_lines = raw_lines[1:]  # header line is skipped for every format
        if fmt != "libsvm":
            header = [t.strip() for t in first.split(sep)]

    label_idx = _resolve_label(label_column, header)
    if model_num_features is not None and fmt != "libsvm":
        ncols = len(raw_lines[0].split(sep))
        if ncols == model_num_features:
            label_idx = None  # no label column in the prediction file
        elif ncols != model_num_features + 1:
            log.fatal(
                "Prediction data has %d columns but the model needs %d features"
                % (ncols, model_num_features)
            )

    if fmt == "libsvm":
        return _parse_libsvm(raw_lines, model_num_features) + (None,)
    return _parse_delimited(raw_lines, sep, label_idx, header)


def _resolve_label(label_column: str, header: Optional[List[str]]) -> int:
    if not label_column:
        return 0
    if label_column.startswith("name:"):
        name = label_column[5:]
        if header is None or name not in header:
            log.fatal("Could not find label column '%s' in data file header" % name)
        return header.index(name)
    return int(label_column)


def _parse_delimited(lines, sep, label_idx, header):
    rows = []
    labels = []
    for ln in lines:
        toks = ln.split(sep)
        vals = [float(t) if t.strip() not in _MISSING_TOKENS else np.nan for t in toks]
        if label_idx is not None:
            labels.append(vals[label_idx])
            del vals[label_idx]
        rows.append(vals)
    X = np.asarray(rows, np.float64)
    y = np.asarray(labels, np.float64) if label_idx is not None else None
    names = None
    if header is not None:
        names = [h for i, h in enumerate(header) if i != label_idx]
    return X, y, names


def _parse_libsvm(lines, model_num_features=None):
    # a leading token without ':' is the label; prediction files may omit it
    has_label = bool(lines) and ":" not in lines[0].split()[0]
    labels = []
    entries = []
    max_idx = -1
    for ln in lines:
        toks = ln.split()
        if has_label:
            labels.append(float(toks[0]))
            toks = toks[1:]
        row = []
        for t in toks:
            if ":" not in t:
                continue
            i, v = t.split(":", 1)
            i = int(i)
            row.append((i, float(v)))
            max_idx = max(max_idx, i)
        entries.append(row)
    # sparse files may not reach the model's highest feature index; pad width
    width = max_idx + 1
    if model_num_features is not None:
        width = max(width, model_num_features)
    X = np.zeros((len(lines), width), np.float64)
    for r, row in enumerate(entries):
        for i, v in row:
            X[r, i] = v
    return X, (np.asarray(labels, np.float64) if has_label else None)


def load_sidecar(path: str, kind: str) -> Optional[np.ndarray]:
    """<data>.weight / <data>.query / <data>.init sidecar files (metadata.cpp)."""
    side = path + "." + kind
    if not vexists(side):
        return None
    vals = []
    with vopen(side) as fh:
        for ln in fh:
            ln = ln.strip()
            if ln:
                vals.append(float(ln))
    log.info("Loading %s from %s" % (kind, side))
    return np.asarray(vals, np.float64)
