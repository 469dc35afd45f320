"""Write the SentencePiece test fixture under tests/torch_spm_fixture/.

    python tests/torch_spm_fixture/make_fixture.py [--output DIR]

It lives with the tests because it needs `tokenizers`, `transformers` and
`protobuf`, which the port never imports: a BPE
vocabulary is trained with `tokenizers`' BpeTrainer over the repository's
own text (every tracked .py and .md file at the time of the run, lines
holding "<0x" left out so that no merged piece spells a byte piece, tabs
and other control characters left out so that they take byte fallback, as
LLaMA's do) and written as a `tokenizer.model` in LLaMA-2's layout:
`<unk>` 0, `<s>` 1, `</s>` 2, the 256 `<0xXX>` byte pieces, the merged
pieces by falling score (-rank of the merge), then the single characters;
BPE, `byte_fallback`, the `identity` normalizer with `add_dummy_prefix`
and no extra-whitespace removal. 32,000 pieces where the text yields
enough merges (the count is printed and stored in expected.json). Beside
it: `tokenizer_config.json` and `special_tokens_map.json` as LLaMA-2's
HF directory has them (`legacy` false), and `expected.json`: for each
string of `tests/torch_spm_oracle.corpus()`, under `legacy` true and
false, the ids of the fast oracle (`torch_spm_oracle.fast_oracle`) and its
decode with special tokens skipped, and where transformers' slow class
(the JAX package's) decodes otherwise, its text as `slow_decoded`.

A later run over a changed repository gives another vocabulary; the
committed files are what the tests and `chip_smoke.py` read.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

N_PIECES = 32000
N_RESERVED = 3 + 256
SPACE = "▁"
SPECIAL = {"content": "", "lstrip": False, "normalized": False,
           "rstrip": False, "single_word": False}


def training_lines(out_dir):
    files = subprocess.run(["git", "ls-files", "*.py", "*.md"], cwd=ROOT,
                           capture_output=True, text=True,
                           check=True).stdout.split()
    skip = os.path.relpath(out_dir, ROOT)
    for name in sorted(files):
        if name.startswith(skip):
            continue
        with open(os.path.join(ROOT, name), encoding="utf-8",
                  errors="replace") as fh:
            for line in fh.read().splitlines():
                line = "".join(c for c in line if c >= " " and c != "\x7f")
                if line.strip() and "<0x" not in line:
                    yield line


def train_pieces(out_dir):
    """(merged pieces in merge order, single characters) of a BPE over
    the repository's text."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement=SPACE, prepend_scheme="always", split=True)
    trainer = trainers.BpeTrainer(vocab_size=N_PIECES - N_RESERVED + 64,
                                  min_frequency=2, show_progress=False)
    tok.train_from_iterator(training_lines(out_dir), trainer)
    model = json.loads(tok.to_str())["model"]
    reserved = {"<unk>", "<s>", "</s>"} | {f"<0x{b:02X}>" for b in
                                           range(256)}
    merged = []
    seen = set()
    for merge in model["merges"]:
        a, b = merge if isinstance(merge, list) else merge.split(" ", 1)
        if a + b not in seen and a + b not in reserved:
            seen.add(a + b)
            merged.append(a + b)
    chars = [t for t, _ in sorted(model["vocab"].items(), key=lambda x: x[1])
             if t not in seen and t not in reserved]
    return merged, chars


def write_model(path, merged, chars):
    from transformers.convert_slow_tokenizer import import_protobuf

    pb = import_protobuf()
    m = pb.ModelProto()
    kinds = pb.ModelProto.SentencePiece

    def add(piece, score, kind):
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind

    add("<unk>", 0.0, kinds.UNKNOWN)
    add("<s>", 0.0, kinds.CONTROL)
    add("</s>", 0.0, kinds.CONTROL)
    for b in range(256):
        add(f"<0x{b:02X}>", 0.0, kinds.BYTE)
    for k, piece in enumerate(merged):
        add(piece, -float(k), kinds.NORMAL)
    for k, piece in enumerate(chars):
        add(piece, -float(len(merged) + k), kinds.NORMAL)
    ts = m.trainer_spec
    ts.model_type = pb.TrainerSpec.BPE
    ts.vocab_size = len(m.pieces)
    ts.byte_fallback = True
    ts.split_digits = True
    ts.character_coverage = 0.99995
    ts.max_sentencepiece_length = 16
    ts.allow_whitespace_only_pieces = True
    ts.unk_id, ts.bos_id, ts.eos_id, ts.pad_id = 0, 1, 2, -1
    ns = m.normalizer_spec
    ns.name = "identity"
    ns.add_dummy_prefix = True
    ns.remove_extra_whitespaces = False
    ns.escape_whitespaces = True
    with open(path, "wb") as fh:
        fh.write(m.SerializeToString())
    return len(m.pieces)


def write_configs(out_dir):
    def special(content):
        return dict(SPECIAL, content=content)

    config = {"add_bos_token": True, "add_eos_token": False,
              "bos_token": dict(special("<s>"), __type="AddedToken"),
              "clean_up_tokenization_spaces": False,
              "eos_token": dict(special("</s>"), __type="AddedToken"),
              "legacy": False, "model_max_length": 1000000000000000019884624838656,
              "pad_token": None, "padding_side": "right",
              "sp_model_kwargs": {}, "tokenizer_class": "LlamaTokenizer",
              "unk_token": dict(special("<unk>"), __type="AddedToken")}
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as fh:
        json.dump(config, fh, indent=2)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as fh:
        json.dump({"bos_token": special("<s>"), "eos_token": special("</s>"),
                   "unk_token": special("<unk>")}, fh, indent=2)


def expected(out_dir, n_pieces):
    from tests.torch_spm_oracle import corpus, fast_oracle, slow_oracle

    model_file = os.path.join(out_dir, "tokenizer.model")
    modes = {}
    for legacy in (True, False):
        fast = fast_oracle(model_file, legacy)
        slow = slow_oracle(out_dir, legacy=legacy)
        rows = []
        for text in corpus():
            ids = fast(text).input_ids
            row = {"ids": ids,
                   "decoded": fast.decode(ids, skip_special_tokens=True)}
            slow_ids = slow(text).input_ids
            if slow_ids != ids:
                row["slow_ids"] = slow_ids
            slow_text = slow.decode(slow_ids, skip_special_tokens=True)
            if slow_text != row["decoded"]:
                row["slow_decoded"] = slow_text
            rows.append(row)
        modes["legacy" if legacy else "non_legacy"] = rows
    with open(os.path.join(out_dir, "expected.json"), "w") as fh:
        json.dump({"pieces": n_pieces, "corpus": corpus(), **modes}, fh,
                  indent=1, ensure_ascii=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", default=os.path.join(ROOT, "tests",
                                                     "torch_spm_fixture"))
    args = ap.parse_args()
    os.makedirs(args.output, exist_ok=True)
    merged, chars = train_pieces(args.output)
    # the merged pieces that fit beside the characters and reserved ones
    merged = merged[:N_PIECES - N_RESERVED - len(chars)]
    n = write_model(os.path.join(args.output, "tokenizer.model"), merged,
                    chars)
    write_configs(args.output)
    expected(args.output, n)
    print(json.dumps({"pieces": n, "merged": len(merged),
                      "characters": len(chars)}))


if __name__ == "__main__":
    main()
