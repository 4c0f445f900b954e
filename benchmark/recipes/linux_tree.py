"""A built Linux kernel checkout, made from the seed.

The stand-in for the tree of ripgrep's benchsuite `linux_literal` (rg
PM_RESUME over a checkout of the Linux kernel that benchsuite builds first,
so that .gitignore has build output to drop). That tree is not in the
repository; this recipe makes one of its shape, every number of which is
assumed (PARAMS, below, gives them for the whole stand-in):

- top-level subtrees by name (arch, drivers, fs, ...), each with its share
  of the directories and files; in each, the directories form a random
  recursive tree at most `max_depth` levels below the root;
- source files named from a vocabulary, with the kernel's kinds of
  extension, of C-like text lines (keywords, identifiers, braces), their
  sizes log-normal, a few empty;
- a few large generated headers (over 1 MiB: the solo route), one with a
  NUL in its first KiB (passed over as binary) and one with a NUL past it;
- build output for a share of the .c files: `.o` (a skipped extension)
  and a hidden `.<name>.o.cmd`; `*.mod.c` and `modules.order` files; tools
  built in the tree (extension-less binaries, named in nested .gitignore
  files); `vmlinux` and `Module.symvers` at the root;
- the root .gitignore and nested ones with plain, glob, dir-only, negated
  and leading-'/' lines, with the files and directories they name;
- hidden and skip-listed directories, skipped extensions (one in capitals),
  a `.min.` asset, symbolic links to a file and to a directory;
- the literal `planted` on `planted_lines` lines of `planted_files` files
  (the first line of one, the unended last line of another, twice on one
  line of a third), one large header and one negation's file, and also in
  files that --gitignore or the binary sniff passes over.

The layout is drawn from `layout_seed`, the same for every run's seed, so
that every seed's tree holds the same files of the same sizes: the seed
changes what they hold, not the work. Text comes from one pool of C-like
lines drawn from the seed, each file a slice of it at an offset of its
own; binary files are random bytes. The same seed and parameters give the
same tree, byte for byte, in the same order of creation.

    make(dest, params, seed) -> {"tree": path}
"""

from __future__ import annotations

import os

import numpy as np

# The stand-in's parameters, every number assumed. With every subtree of
# `shares` made: about 55,000 files under 4,000 directories, about 0.7 GB
# searched. `subtrees` makes only those listed (arch, Documentation,
# include, net, sound and tools cut, so that one query takes 2-5 s on an
# H100's host): 30,312 files, 0.45 GB searched with --gitignore. A
# configuration's file gives its own.
PARAMS = {
    "root": "linux",
    "layout_seed": 19,
    "shares": {"arch": 0.17, "Documentation": 0.06, "block": 0.003, "certs": 0.001,
               "crypto": 0.005, "drivers": 0.43, "fs": 0.07, "include": 0.08, "init": 0.001,
               "ipc": 0.001, "kernel": 0.014, "lib": 0.01, "mm": 0.004, "net": 0.045,
               "samples": 0.004, "scripts": 0.01, "security": 0.005, "sound": 0.05,
               "tools": 0.035, "usr": 0.001, "virt": 0.001},
    "subtrees": ["block", "certs", "crypto", "drivers", "fs", "init", "ipc", "kernel", "lib",
                 "mm", "samples", "scripts", "security", "usr", "virt"],
    "source_files": 48000,
    "dirs": 4000,
    "max_depth": 7,
    "size_median_bytes": 6144,
    "size_sigma": 1.245,
    "size_max_bytes": 524288,
    "empty_share": 0.003,
    "big_files": 30,
    "big_min_bytes": 1048577,
    "big_max_bytes": 9437184,
    "build_output_share": 0.1,
    "nested_gitignores": 200,
    "planted": "PM_RESUME",
    "planted_lines": 20,
    "planted_files": 12,
}

KEYWORDS = (b"static int void struct return if else for while unsigned long const char "
            b"u8 u16 u32 u64 bool true false NULL sizeof break case default switch goto "
            b"unlikely likely inline extern enum union volatile __init __iomem").split()
IDENTS = (b"dev priv ret data buf len reg val mask offset flags lock irq pdev ctx page skb "
          b"inode file sb node list head entry count state cfg ops res base addr size idx "
          b"port chip hw info desc queue work timer clk phy regs err out i j "
          b"dev->priv &dev->lock pdev->dev spin_lock(&priv->lock); mutex_unlock(&lock); "
          b"PM_SUSPEND PM_EVENT_RESUME pm_resume pm_runtime_resume RESUME PM_RESTORE").split()
PUNCT = (b"{ } ( ); = == != && || * & + - 0 1 2 0x0 << >> , ; : [ ] -EINVAL; -ENOMEM; "
         b"-ENODEV; /* */ #include #define #ifdef #endif <linux/module.h> <linux/kernel.h> "
         b"<linux/slab.h> <linux/pm.h>").split()
TOKENS = KEYWORDS * 2 + IDENTS * 3 + PUNCT * 2
SEPS = [b" "] * 40 + [b"\n"] * 6 + [b"\n\t"] * 3 + [b"\n\n"]

DIR_WORDS = ("core host usb net pci i2c spi gpio media video drm gpu amd intel nouveau "
             "radeon soc codecs ext4 btrfs xfs nfs sched time irq power cpufreq acpi "
             "platform x86 arm arm64 mips powerpc riscv s390 boot dts uapi asm generic md "
             "scsi ata mmc mtd input hid tty serial char misc firmware wireless ethernet "
             "mellanox broadcom realtek qcom samsung rockchip mediatek tegra imx renesas "
             "perf testing selftests kconfig dtc mach common display bridge panel phy "
             "regulator clk pinctrl iio hwmon thermal watchdog rtc dma crypto block").split()
STEM_WORDS = ("core main dev drv bus ctrl hw regs irq dma clk pm phy mac sysfs debugfs "
              "ioctl proc init setup probe ops util common base table map trace stats "
              "queue ring fifo mem page cache buf io timer event notify mgr link port").split()
# extensions of source files, in the kernel's rough proportions ("" for a
# name with none, such as Makefile or Kconfig)
EXTS = ([".c"] * 42 + [".h"] * 33 + [".S"] * 2 + [".dts", ".dtsi"] * 2 + [".rst"] * 4
        + [".txt", ".sh", ".py", ".yaml", ".json", ".svg", ".lds"] + [""] * 7)
PLAIN_NAMES = ("Makefile", "Kconfig", "Kbuild", "README", "TODO")
TOOLS = ("fixdep conmakehash gen_init_cpio mkcpustr recordmcount sortextable unifdef "
         "kallsyms genksyms modpost mdp bin2c asn1_compiler sign-file extract-cert "
         "mktables gen_crc32table insert-sys-cert gen-hyprel relocs").split()

ROOT_GITIGNORE = b"""#
# NOTE! Don't add files that are generated in specific
# subdirectories here. Add them in the ".gitignore" file
# in that subdirectory instead.
#
# Normal rules (sorted alphabetically)
#
.*
*.a
*.ko
*.lst
*.mod.c
*.o
*.symtypes
modules.order

#
# Top-level generic files
#
/tags
/TAGS
/vmlinux
/Module.symvers

# We don't want to ignore the following even if they are dot-files
!.gitignore
!.mailmap
"""
ROOT_TEXT = ("COPYING", "CREDITS", "MAINTAINERS", "Makefile", "README", "Kbuild", "Kconfig",
             "modules.order", "Module.symvers", ".mailmap", ".clang-format", ".cocciconfig",
             ".get_maintainer.ignore")
FILLER_LINES = ("*.lst", "*.so.dbg", "/vmlinux.lds", "*.dtb.S", "\t*.tmp  ", "# generated",
                "  # an indented comment", "", "/*.asn1.[ch]")


class _Tree:
    """The tree's entries before they are written: directories (name,
    parent, depth) and files (directory, name, kind, size, extra)."""

    def __init__(self, root: str):
        self.dir_name = [root]
        self.dir_parent = [-1]
        self.dir_depth = [0]
        self.children: list[dict] = [{}]   # name -> "dir" | "file", per directory
        self.files: list[list] = []         # [dir, name, kind, size, extra]

    def add_dir(self, parent: int, name: str) -> int:
        name = self.unique(parent, name)
        self.dir_name.append(name)
        self.dir_parent.append(parent)
        self.dir_depth.append(self.dir_depth[parent] + 1)
        self.children.append({})
        self.children[parent][name] = "dir"
        return len(self.dir_name) - 1

    def add_file(self, d: int, name: str, kind: str, size: int = 0, extra=None) -> int:
        name = self.unique(d, name)
        self.children[d][name] = "file"
        self.files.append([d, name, kind, int(size), extra])
        return len(self.files) - 1

    def unique(self, d: int, name: str) -> str:
        if name not in self.children[d]:
            return name
        stem, dot, ext = name.partition(".") if not name.startswith(".") else (name, "", "")
        k = 2
        while f"{stem}{k}{dot}{ext}" in self.children[d]:
            k += 1
        return f"{stem}{k}{dot}{ext}"

    def path(self, d: int) -> str:
        parts = []
        while d >= 0:
            parts.append(self.dir_name[d])
            d = self.dir_parent[d]
        return os.path.join(*reversed(parts))


def _pool(rng: np.random.Generator, size: int) -> np.ndarray:
    """`size` bytes of C-like lines: tokens, each followed by a space or a
    line break, about 30 bytes a line."""
    pieces = TOKENS + SEPS
    table = np.frombuffer(b"".join(pieces), np.uint8)
    lens = np.array([len(p) for p in pieces], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    n = size // 4 + 64
    ids = np.empty(2 * n, np.int64)
    ids[0::2] = rng.integers(0, len(TOKENS), n)
    ids[1::2] = len(TOKENS) + rng.integers(0, len(SEPS), n)
    ln = lens[ids]
    starts = np.cumsum(ln) - ln
    idx = np.repeat(offs[ids] - starts, ln) + np.arange(int(ln.sum()))
    out = table[idx]
    while out.shape[0] < size:  # too few bytes drawn: draw more
        out = np.concatenate([out, _pool(rng, size - out.shape[0])])
    return out[:size]


def _pick(rng, seq):
    return seq[int(rng.integers(0, len(seq)))]


def _stem(rng) -> str:
    a, b = _pick(rng, STEM_WORDS), _pick(rng, DIR_WORDS)
    return f"{b}_{a}" if rng.random() < 0.7 else f"{b}{a}"


def _layout(rng: np.random.Generator, p: dict) -> tuple[_Tree, list, list]:
    """The tree's directories and files; the plants in files of their own
    kind, (file, mode); and the ordinary source files that may hold the
    others."""
    t = _Tree(p["root"])
    full = sum(p["shares"].values())
    kept = {k: v for k, v in p["shares"].items() if k in p["subtrees"]}
    max_depth = int(p["max_depth"])
    subtree_dirs = []
    for name, share in kept.items():
        k = max(1, round(p["dirs"] * share / full))
        top = t.add_dir(0, name)
        ids = [top]
        for i in range(1, k):
            parent = ids[int(rng.integers(0, i))]
            while t.dir_depth[parent] >= max_depth:
                parent = t.dir_parent[parent]
            ids.append(t.add_dir(parent, _pick(rng, DIR_WORDS)))
        subtree_dirs.append((ids, share))
    all_dirs = [d for ids, _ in subtree_dirs for d in ids]
    deep = [d for d in all_dirs if t.dir_depth[d] >= 3] or all_dirs

    # source files, their sizes log-normal, a few empty
    n_src = sum(max(1, round(p["source_files"] * s / full)) for _, s in subtree_dirs)
    sizes = np.minimum(rng.lognormal(np.log(p["size_median_bytes"]), p["size_sigma"], n_src),
                       p["size_max_bytes"]).astype(np.int64)
    sizes[rng.choice(n_src, max(1, round(n_src * p["empty_share"])), replace=False)] = 0
    unended = np.zeros(n_src, bool)             # no newline at the end
    unended[rng.choice(n_src, max(1, round(n_src * 0.01)), replace=False)] = True
    src = []
    i = 0
    for ids, share in subtree_dirs:
        for _ in range(max(1, round(p["source_files"] * share / full))):
            d = ids[int(rng.integers(0, len(ids)))]
            ext = _pick(rng, EXTS)
            name = _pick(rng, PLAIN_NAMES) if ext == "" else _stem(rng) + ext
            f = t.add_file(d, name, "text", sizes[i], {"unended": bool(unended[i])})
            src.append(f)
            i += 1

    # build output beside a share of the .c files, module files
    for f in list(src):
        d, name = t.files[f][0], t.files[f][1]
        if not name.endswith(".c"):
            continue
        r = rng.random()
        if r < p["build_output_share"]:
            stem = name[:-2]
            t.add_file(d, stem + ".o", "binary", int(rng.integers(2048, 65536)))
            t.add_file(d, f".{stem}.o.cmd", "text", int(rng.integers(600, 4096)))
        elif r < p["build_output_share"] + 0.02:
            t.add_file(d, name[:-2] + ".mod.c", "text", int(rng.integers(800, 3000)))
    for d in all_dirs:
        if rng.random() < 0.03:
            t.add_file(d, "modules.order", "text", int(rng.integers(40, 2000)))
            t.add_file(d, "built-in.a", "binary", int(rng.integers(1024, 32768)))

    # large generated headers: the solo route; one sniffed out, one with a NUL past the sniff
    big = []
    lo, hi = np.log(p["big_min_bytes"]), np.log(p["big_max_bytes"])
    for j in range(max(3, int(p["big_files"]))):
        size = int(np.exp(rng.uniform(lo, hi)))
        nul = {0: int(rng.integers(0, 1024)), 1: int(rng.integers(2048, 1 << 20))}.get(j)
        name = f"{_pick(rng, DIR_WORDS)}_{j}_{'sh_mask' if j % 2 else 'offset'}.h"
        big.append(t.add_file(_pick(rng, deep), name, "text", size, {"nul": nul}))

    # root files: the root .gitignore, hidden files, vmlinux, hidden and skip-listed dirs
    t.add_file(0, ".gitignore", "fixed", extra=ROOT_GITIGNORE)
    for name in ROOT_TEXT:
        t.add_file(0, name, "text", int(rng.integers(200, 400_000 if name == "MAINTAINERS"
                                                     else 20_000)))
    t.add_file(0, "vmlinux", "binary", int(rng.integers(1 << 21, 3 << 20)))
    for hidden in (".git", ".tmp_versions"):
        h = t.add_dir(0, hidden)
        for k in range(5):
            t.add_file(h, f"{_stem(rng)}.mod" if hidden == ".tmp_versions" else f"pack{k}",
                       "text", int(rng.integers(100, 5000)))
    skipped = t.add_dir(_pick(rng, all_dirs), "build")
    for _ in range(4):
        t.add_file(skipped, _stem(rng) + ".c", "text", int(rng.integers(500, 8000)))
    assets = _pick(rng, all_dirs)
    t.add_file(assets, "jquery.min.js", "text", int(rng.integers(2000, 60000)))
    t.add_file(assets, "logo.GIF", "binary", int(rng.integers(2000, 20000)))
    t.add_file(assets, "screen.png", "binary", int(rng.integers(2000, 20000)))
    linked = _pick(rng, deep)
    target = next((t.files[f][1] for f in src if t.files[f][0] == linked), "Makefile")
    t.add_file(linked, "linked.h", "link", extra=target)
    t.add_file(linked, "up", "link", extra="..")

    # nested .gitignore files, each with the files that its lines name
    lines: dict[int, list[str]] = {}
    plants = []
    kids = {}
    for d in all_dirs:
        kids.setdefault(t.dir_parent[d], []).append(d)
    chosen = rng.choice(np.array(all_dirs[1:] or all_dirs), min(int(p["nested_gitignores"]),
                        max(1, len(all_dirs) - 1)), replace=False)
    for j, d in enumerate(int(x) for x in chosen):
        kind = j % 4
        own = lines.setdefault(d, [])
        if rng.random() < 0.5:
            own.append("# " + _pick(rng, STEM_WORDS) + " build output")
        if kind == 0:    # a tool built in the tree: plain or leading-'/' line
            tool = t.unique(d, _pick(rng, TOOLS))
            t.add_file(d, tool, "binary", int(rng.integers(8192, 200_000)))
            own.append(("/" if rng.random() < 0.5 else "") + tool)
        elif kind == 1:  # generated sources: a glob, one re-included by negation
            stem = _stem(rng)
            t.add_file(d, stem + ".tab.c", "text", int(rng.integers(2000, 40000)))
            t.add_file(d, stem + ".tab.h", "text", int(rng.integers(500, 5000)))
            keep = t.add_file(d, "keep_" + stem + ".tab.c", "text", int(rng.integers(500, 5000)))
            own += ["*.tab.[ch]", "!keep_*.tab.c"]
            if j == 1:
                plants.append((keep, "line"))
            sub = kids.get(d)
            if sub:      # a child's own .gitignore re-includes what its parent's ignores
                e = sub[0]
                t.add_file(e, _stem(rng) + ".tab.h", "text", int(rng.integers(500, 5000)))
                t.add_file(e, _stem(rng) + ".tab.c", "text", int(rng.integers(500, 5000)))
                lines.setdefault(e, []).append("!*.tab.h")
        elif kind == 2:  # a dir-only line: the directory goes, a file of that name stays
            g = t.add_dir(d, "generated")
            for _ in range(int(rng.integers(2, 5))):
                f = t.add_file(g, _stem(rng) + ".h", "text", int(rng.integers(500, 8000)))
            if j == 2:
                plants.append((f, "line"))
            own.append("generated/")
            sub = kids.get(d)
            if sub:
                t.add_file(sub[0], "generated", "text", int(rng.integers(200, 2000)))
        else:            # lines that name nothing here
            own += [_pick(rng, FILLER_LINES) for _ in range(int(rng.integers(1, 4)))]
    for d, own in lines.items():
        t.add_file(d, ".gitignore", "fixed", extra=("\n".join(own) + "\n").encode())

    # plants in a searched large header, the sniffed-out one, build output
    # that --gitignore drops; the others go into ordinary source files
    plants += [(big[2], "line"), (big[0], "line")]
    cmd = next((f for f, e in enumerate(t.files) if e[1].endswith(".o.cmd")), None)
    if cmd is not None:
        plants.append((cmd, "line"))
    hosts = [f for f in src if t.files[f][3] >= 256 and t.files[f][1].endswith((".c", ".h"))]
    return t, plants, hosts


def _plant(data: np.ndarray, literal: bytes, mode: str, rng: np.random.Generator) -> None:
    lit = np.frombuffer(literal, np.uint8)
    n, m = data.shape[0], lit.shape[0]
    if n < 2 * m + 2:
        return
    if mode == "start":
        data[:m] = lit
    elif mode == "end":
        data[n - m:] = lit
    else:
        at = int(rng.integers(0, n - 2 * m - 2))
        nl = np.flatnonzero(data[at : n - 2 * m - 1] == 10)
        at = at + int(nl[0]) + 1 if nl.shape[0] else at
        data[at : at + m] = lit
        if mode == "twice":
            data[at + m : at + 2 * m] = lit


def make(dest: str, params: dict, seed: int) -> dict:
    """The tree under dest/<root>. Its layout (directories, names, sizes,
    kinds, the order of creation) is drawn from `layout_seed`, the same
    for every seed, so that every run searches the same amount of work;
    the text, the binary bytes and which files hold the plants, from
    `seed`."""
    t, plants, hosts = _layout(np.random.default_rng(int(params["layout_seed"])), params)
    rng = np.random.default_rng(seed)
    n_files = min(int(params["planted_files"]), len(hosts))
    hosts = [hosts[int(k)] for k in rng.choice(len(hosts), n_files, replace=False)]
    modes = ["start", "end", "twice"] + ["line"] * max(0, int(params["planted_lines"]) - 3)
    plants += [(hosts[k % len(hosts)], mode) for k, mode in enumerate(modes)]
    literal = params["planted"].encode()
    by_file: dict[int, list[str]] = {}
    for f, mode in plants:
        by_file.setdefault(f, []).append(mode)
    texts = [e[3] for e in t.files if e[2] == "text"]
    pool = _pool(rng, max(texts + [1]) + (16 << 20))
    starts = rng.integers(0, pool.shape[0] - max(texts + [0]), len(t.files))

    for d in range(len(t.dir_name)):
        os.makedirs(os.path.join(dest, t.path(d)), exist_ok=True)
    for f, (d, name, kind, size, extra) in enumerate(t.files):
        path = os.path.join(dest, t.path(d), name)
        if kind == "link":
            os.symlink(extra, path)
            continue
        if kind == "fixed":
            data = np.frombuffer(extra, np.uint8)
        elif kind == "binary":
            data = rng.integers(0, 256, size, dtype=np.uint8)
            data[: 64] = 0  # an object's header: NULs in the first KiB
        else:
            data = pool[starts[f] : starts[f] + size]
            extra = extra or {}
            if f in by_file or extra.get("nul") is not None or (size and not extra.get(
                    "unended") and data[-1] != 10):
                data = data.copy()
                if size and not extra.get("unended"):
                    data[-1] = 10
                for mode in by_file.get(f, []):
                    _plant(data, literal, mode, rng)
                if extra.get("nul") is not None:
                    data[min(extra["nul"], size - 1)] = 0
        with open(path, "wb") as fh:
            fh.write(data.data)
    return {"tree": os.path.join(dest, params["root"])}
