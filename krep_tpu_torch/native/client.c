/* krep — thin native client for the krep_tpu_torch resident engine
 * (krep_tpu_torch/daemon.py).
 *
 * Copy of krep_tpu/native/client.c for the PyTorch port. The reference is
 * a C binary with zero startup cost (its small-file regime is one
 * open+read+scan, krep.c:3402-3430). A Python+PyTorch process pays for
 * the interpreter, the torch import and the CUDA context before scanning
 * a byte. This client restores the C-binary wall time: connect to the
 * resident engine over a unix socket, pass the real stdin/stdout/stderr
 * fds via SCM_RIGHTS (so streaming, --color=auto isatty detection, and
 * SIGPIPE all behave exactly as if the CLI ran in this process), forward
 * argv + cwd + KREP_TPU_* and KREP_TORCH_* env, and exit with the
 * engine's return code.
 *
 * No daemon reachable: optionally autospawn one (for the next call) and
 * exec the port's Python CLI directly for this call — results are always
 * identical, only the startup cost differs.
 *
 * The default socket, torch-daemon-<uid>.sock, is not the JAX package's
 * daemon-<uid>.sock: neither daemon answers the other's client.
 *
 * Build: krep_tpu_torch/native/client.py build_client() (or
 * `make client-torch`), which bakes the repo root + python path.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#ifndef KREP_TPU_ROOT
#define KREP_TPU_ROOT ""
#endif
#ifndef KREP_TPU_PYTHON_DEFAULT
#define KREP_TPU_PYTHON_DEFAULT "python3"
#endif

#define MAGIC_REQ "KRPD"
#define MAGIC_RESP "KRPR"
#define PROTO_VERSION 1u

extern char **environ;

static const char *python_exe(void)
{
    const char *p = getenv("KREP_TPU_PYTHON");
    return (p && *p) ? p : KREP_TPU_PYTHON_DEFAULT;
}

static void export_pythonpath(void)
{
    if (!*KREP_TPU_ROOT)
        return;
    const char *cur = getenv("PYTHONPATH");
    if (cur && strstr(cur, KREP_TPU_ROOT))
        return;
    char buf[4096];
    if (cur && *cur)
        snprintf(buf, sizeof buf, "%s:%s", KREP_TPU_ROOT, cur);
    else
        snprintf(buf, sizeof buf, "%s", KREP_TPU_ROOT);
    setenv("PYTHONPATH", buf, 1);
}

static void sock_path(char *out, size_t cap)
{
    const char *env = getenv("KREP_TPU_DAEMON_SOCK");
    if (env && *env) {
        snprintf(out, cap, "%s", env);
        return;
    }
    const char *cache = getenv("KREP_TPU_CACHE_DIR");
    if (cache && *cache)
        snprintf(out, cap, "%s/torch-daemon-%ld.sock", cache, (long)getuid());
    else {
        const char *home = getenv("HOME");
        snprintf(out, cap, "%s/.cache/krep_tpu/torch-daemon-%ld.sock",
                 home ? home : "/tmp", (long)getuid());
    }
}

/* exec the Python CLI in this process (cold path; never returns on
 * success). */
static void fallback_exec(int argc, char **argv)
{
    export_pythonpath();
    char **nargv = malloc(((size_t)argc + 4) * sizeof *nargv);
    if (!nargv) {
        perror("krep");
        exit(2);
    }
    int k = 0;
    nargv[k++] = (char *)python_exe();
    nargv[k++] = "-m";
    nargv[k++] = "krep_tpu_torch.cli";
    for (int i = 1; i < argc; ++i)
        nargv[k++] = argv[i];
    nargv[k] = NULL;
    execvp(nargv[0], nargv);
    fprintf(stderr, "krep: cannot exec %s: %s\n", nargv[0], strerror(errno));
    exit(2);
}

/* detach and start the daemon so the NEXT invocation is warm */
static void autospawn_daemon(void)
{
    const char *as = getenv("KREP_TPU_DAEMON_AUTOSPAWN");
    if (as && strcmp(as, "0") == 0)
        return;
    pid_t pid = fork();
    if (pid != 0)
        return; /* parent (or fork failure): move on */
    setsid();
    int devnull = open("/dev/null", O_RDWR);
    if (devnull >= 0) {
        dup2(devnull, 0);
        dup2(devnull, 1);
        dup2(devnull, 2);
        if (devnull > 2)
            close(devnull);
    }
    export_pythonpath();
    execlp(python_exe(), python_exe(), "-m", "krep_tpu_torch.daemon",
           "--foreground", (char *)NULL);
    _exit(127);
}

static int send_all(int fd, const void *buf, size_t n)
{
    const char *p = buf;
    while (n) {
        ssize_t w = write(fd, p, n);
        if (w < 0) {
            if (errno == EINTR)
                continue;
            return -1;
        }
        p += w;
        n -= (size_t)w;
    }
    return 0;
}

static int recv_all(int fd, void *buf, size_t n)
{
    char *p = buf;
    while (n) {
        ssize_t r = read(fd, p, n);
        if (r < 0) {
            if (errno == EINTR)
                continue;
            return -1;
        }
        if (r == 0)
            return -1;
        p += r;
        n -= (size_t)r;
    }
    return 0;
}

struct blob {
    char *p;
    size_t len, cap;
};

static void blob_put(struct blob *b, const void *src, size_t n)
{
    if (b->len + n > b->cap) {
        b->cap = (b->cap ? b->cap * 2 : 4096);
        while (b->cap < b->len + n)
            b->cap *= 2;
        b->p = realloc(b->p, b->cap);
        if (!b->p) {
            perror("krep");
            exit(2);
        }
    }
    memcpy(b->p + b->len, src, n);
    b->len += n;
}

/* the env the engine honours per request: its knobs and the device */
static int forwarded(const char *kv)
{
    return strncmp(kv, "KREP_TPU_", 9) == 0 || strncmp(kv, "KREP_TORCH_", 11) == 0;
}

static void blob_u32(struct blob *b, uint32_t v) { blob_put(b, &v, 4); }
static void blob_cstr(struct blob *b, const char *s)
{
    blob_put(b, s, strlen(s) + 1);
}

int main(int argc, char **argv)
{
    const char *nd = getenv("KREP_TPU_NO_DAEMON");
    if (nd && strcmp(nd, "1") == 0)
        fallback_exec(argc, argv);

    char path[4096];
    sock_path(path, sizeof path);

    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0)
        fallback_exec(argc, argv);
    struct sockaddr_un sa;
    memset(&sa, 0, sizeof sa);
    sa.sun_family = AF_UNIX;
    snprintf(sa.sun_path, sizeof sa.sun_path, "%s", path);
    if (connect(fd, (struct sockaddr *)&sa, sizeof sa) != 0) {
        close(fd);
        autospawn_daemon();
        fallback_exec(argc, argv);
    }

    /* payload: u32 argc | cwd\0 | args\0... | u32 nenv | KEY=VAL\0... */
    struct blob b = {0};
    blob_u32(&b, (uint32_t)(argc - 1));
    char cwd[4096];
    if (!getcwd(cwd, sizeof cwd)) {
        perror("krep: getcwd");
        exit(2);
    }
    blob_cstr(&b, cwd);
    for (int i = 1; i < argc; ++i)
        blob_cstr(&b, argv[i]);
    uint32_t nenv = 0;
    for (char **e = environ; *e; ++e)
        if (forwarded(*e))
            ++nenv;
    blob_u32(&b, nenv);
    for (char **e = environ; *e; ++e)
        if (forwarded(*e))
            blob_cstr(&b, *e);

    /* header (magic | u32 version | u64 payload_len) + SCM_RIGHTS fds */
    unsigned char hdr[16];
    memcpy(hdr, MAGIC_REQ, 4);
    uint32_t ver = PROTO_VERSION;
    uint64_t plen = b.len;
    memcpy(hdr + 4, &ver, 4);
    memcpy(hdr + 8, &plen, 8);

    struct iovec iov = {.iov_base = hdr, .iov_len = sizeof hdr};
    union {
        struct cmsghdr align;
        char buf[CMSG_SPACE(3 * sizeof(int))];
    } u;
    memset(&u, 0, sizeof u);
    struct msghdr msg = {0};
    msg.msg_iov = &iov;
    msg.msg_iovlen = 1;
    msg.msg_control = u.buf;
    msg.msg_controllen = sizeof u.buf;
    struct cmsghdr *cm = CMSG_FIRSTHDR(&msg);
    cm->cmsg_level = SOL_SOCKET;
    cm->cmsg_type = SCM_RIGHTS;
    cm->cmsg_len = CMSG_LEN(3 * sizeof(int));
    int fds[3] = {0, 1, 2};
    memcpy(CMSG_DATA(cm), fds, sizeof fds);

    if (sendmsg(fd, &msg, 0) != (ssize_t)sizeof hdr) {
        /* nothing reached the engine yet: cold path is safe */
        close(fd);
        fallback_exec(argc, argv);
    }
    if (send_all(fd, b.p, b.len) != 0) {
        fprintf(stderr, "krep: daemon connection lost mid-request\n");
        return 2;
    }
    free(b.p);

    unsigned char resp[8];
    if (recv_all(fd, resp, sizeof resp) != 0 ||
        memcmp(resp, MAGIC_RESP, 4) != 0) {
        fprintf(stderr, "krep: daemon returned a bad response\n");
        return 2;
    }
    int32_t rc;
    memcpy(&rc, resp + 4, 4);
    close(fd);
    return (int)rc;
}
