// Async file-I/O engine for the NVMe swap path (ZeRO-Infinity).
//
// Role parity: reference csrc/aio/ (libaio O_DIRECT engine with a
// submission queue drained by deepspeed_aio_thread.cpp).  Here the queue
// IS the kernel's: a raw-syscall io_uring ring (no liburing dependency)
// with queue_depth in-flight ops, O_DIRECT when alignment allows, and
// mlock'd pinned buffers.  The blocking ds_pread/ds_pwrite entry points
// remain as the sync path and the fallback when io_uring is unavailable
// (seccomp'd containers return -EPERM from io_uring_setup).
//
// API (ctypes):
//   void* ds_aio_create(int queue_depth)            NULL if unavailable
//   long  ds_aio_submit_read(h, fname, buf, n, off) >=0 ok, <0 errno
//   long  ds_aio_submit_write(h, fname, buf, n, off)
//   long  ds_aio_drain(h)        wait all in-flight; completed count / <0
//   void  ds_aio_destroy(h)
//   void* ds_alloc_pinned(long nbytes)              4k-aligned + mlock
//   void  ds_free_pinned(void* p, long nbytes)

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <linux/io_uring.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr long kAlign = 4096;

bool aligned(const void* p, long n, long off) {
    return ((reinterpret_cast<uintptr_t>(p) % kAlign) == 0) &&
           (n % kAlign == 0) && (off % kAlign == 0);
}

int sys_io_uring_setup(unsigned entries, io_uring_params* p) {
    return (int)syscall(__NR_io_uring_setup, entries, p);
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
    return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                        flags, nullptr, 0);
}

// IORING_OP_READ/WRITE need kernel >= 5.6 while io_uring_setup exists from
// 5.1 — probe the opcode so 5.1-5.5 kernels fall back to the thread pool
// instead of failing every op with -EINVAL
bool probe_read_write_ops(int ring_fd) {
// IORING_REGISTER_PROBE is an enum; gate on the same-era flag macro.
// io_uring_probe ends in a flexible array member, so size it by hand
// (C++ rejects embedding it in a larger struct).
#ifdef IO_URING_OP_SUPPORTED
    size_t sz = sizeof(io_uring_probe) + 64 * sizeof(io_uring_probe_op);
    std::vector<uint8_t> mem(sz, 0);
    io_uring_probe* pr = reinterpret_cast<io_uring_probe*>(mem.data());
    int r = (int)syscall(__NR_io_uring_register, ring_fd,
                         IORING_REGISTER_PROBE, pr, 64);
    if (r < 0) return false;   // probe itself needs 5.6+ — same cutoff
    if (pr->last_op < IORING_OP_WRITE) return false;
    return (pr->ops[IORING_OP_READ].flags & IO_URING_OP_SUPPORTED) &&
           (pr->ops[IORING_OP_WRITE].flags & IO_URING_OP_SUPPORTED);
#else
    (void)ring_fd;
    return false;              // headers predate the opcodes entirely
#endif
}

// one submitted op: keeps the fd open until completion and remembers the
// request so short transfers can be finished synchronously
struct Op {
    int fd = -1;
    bool write = false;
    char* buf = nullptr;
    long nbytes = 0;
    long offset = 0;
    bool live = false;
};

struct Engine {
    int ring_fd = -1;
    unsigned sq_entries = 0, cq_entries = 0;
    // sq ring pointers
    uint8_t* sq_ring = nullptr; size_t sq_ring_sz = 0;
    uint8_t* cq_ring = nullptr; size_t cq_ring_sz = 0;
    io_uring_sqe* sqes = nullptr; size_t sqes_sz = 0;
    unsigned* sq_head = nullptr; unsigned* sq_tail = nullptr;
    unsigned* sq_mask = nullptr; unsigned* sq_array = nullptr;
    unsigned* cq_head = nullptr; unsigned* cq_tail = nullptr;
    unsigned* cq_mask = nullptr;
    io_uring_cqe* cqes = nullptr;
    bool single_mmap = false;

    std::vector<Op> ops;          // slot table, size = sq_entries
    unsigned inflight = 0;
    long completed_total = 0;
    std::mutex mu;

    ~Engine() {
        if (sqes) munmap(sqes, sqes_sz);
        if (sq_ring) munmap(sq_ring, sq_ring_sz);
        if (cq_ring && !single_mmap) munmap(cq_ring, cq_ring_sz);
        if (ring_fd >= 0) close(ring_fd);
        for (auto& op : ops)
            if (op.live && op.fd >= 0) close(op.fd);
    }
};

// reap every completion currently in the CQ; finish short transfers
// synchronously (rare: page-cache reads at EOF boundaries)
long reap(Engine* e) {
    long n = 0;
    unsigned head = __atomic_load_n(e->cq_head, __ATOMIC_ACQUIRE);
    unsigned tail = __atomic_load_n(e->cq_tail, __ATOMIC_ACQUIRE);
    while (head != tail) {
        io_uring_cqe* c = &e->cqes[head & *e->cq_mask];
        unsigned slot = (unsigned)c->user_data;
        Op& op = e->ops[slot];
        long res = c->res;
        long ok = 0;
        if (res < 0) {
            ok = res;  // errno-style failure
        } else if (res < op.nbytes) {
            // finish the tail synchronously
            long done = res;
            while (done < op.nbytes) {
                ssize_t r = op.write
                    ? pwrite(op.fd, op.buf + done, op.nbytes - done,
                             op.offset + done)
                    : pread(op.fd, op.buf + done, op.nbytes - done,
                            op.offset + done);
                if (r <= 0) { ok = -EIO; break; }
                done += r;
            }
        }
        close(op.fd);
        op.live = false;
        e->inflight--;
        if (ok < 0) n = ok;      // report the first error from drain
        else {
            if (n >= 0) n++;
            e->completed_total++;  // drain reports ALL since last drain,
        }                          // incl. reaps during submit backpressure
        head++;
    }
    __atomic_store_n(e->cq_head, head, __ATOMIC_RELEASE);
    return n;
}

long submit(Engine* e, const char* fname, void* buffer, long nbytes,
            long offset, bool write) {
    std::lock_guard<std::mutex> lock(e->mu);
    // ring full → wait for one completion first
    while (e->inflight >= e->sq_entries) {
        if (sys_io_uring_enter(e->ring_fd, 0, 1, IORING_ENTER_GETEVENTS) < 0)
            return -errno;
        long r = reap(e);
        if (r < 0) return r;
    }
    int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    if (aligned(buffer, nbytes, offset)) flags |= O_DIRECT;
    int fd = open(fname, flags, 0644);
    if (fd < 0 && (flags & O_DIRECT))
        fd = open(fname, flags & ~O_DIRECT, 0644);
    if (fd < 0) return -errno;

    // find a free slot
    unsigned slot = 0;
    while (slot < e->ops.size() && e->ops[slot].live) slot++;
    Op& op = e->ops[slot];
    op = Op{fd, write, static_cast<char*>(buffer), nbytes, offset, true};

    unsigned tail = __atomic_load_n(e->sq_tail, __ATOMIC_ACQUIRE);
    unsigned idx = tail & *e->sq_mask;
    io_uring_sqe* sqe = &e->sqes[idx];
    std::memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = write ? IORING_OP_WRITE : IORING_OP_READ;
    sqe->fd = fd;
    sqe->addr = reinterpret_cast<uint64_t>(buffer);
    sqe->len = (unsigned)nbytes;
    sqe->off = (uint64_t)offset;
    sqe->user_data = slot;
    e->sq_array[idx] = idx;
    __atomic_store_n(e->sq_tail, tail + 1, __ATOMIC_RELEASE);

    int r = sys_io_uring_enter(e->ring_fd, 1, 0, 0);
    if (r < 0) { close(fd); op.live = false; return -errno; }
    e->inflight++;
    return 0;
}

}  // namespace

extern "C" {

void* ds_aio_create(int queue_depth) {
    if (queue_depth < 1) queue_depth = 1;
    io_uring_params p;
    std::memset(&p, 0, sizeof(p));
    int fd = sys_io_uring_setup((unsigned)queue_depth, &p);
    if (fd < 0) return nullptr;   // seccomp / old kernel → caller falls back
    if (!probe_read_write_ops(fd)) { close(fd); return nullptr; }

    Engine* e = new Engine();
    e->ring_fd = fd;
    e->sq_entries = p.sq_entries;
    e->cq_entries = p.cq_entries;
    e->single_mmap = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;

    e->sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    e->cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    if (e->single_mmap && e->cq_ring_sz > e->sq_ring_sz)
        e->sq_ring_sz = e->cq_ring_sz;
    e->sq_ring = static_cast<uint8_t*>(
        mmap(nullptr, e->sq_ring_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING));
    if (e->sq_ring == MAP_FAILED) { e->sq_ring = nullptr; delete e; return nullptr; }
    e->cq_ring = e->single_mmap ? e->sq_ring
        : static_cast<uint8_t*>(
              mmap(nullptr, e->cq_ring_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING));
    if (e->cq_ring == MAP_FAILED) { e->cq_ring = nullptr; delete e; return nullptr; }
    e->sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
    e->sqes = static_cast<io_uring_sqe*>(
        mmap(nullptr, e->sqes_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES));
    if (e->sqes == MAP_FAILED) { e->sqes = nullptr; delete e; return nullptr; }

    e->sq_head = reinterpret_cast<unsigned*>(e->sq_ring + p.sq_off.head);
    e->sq_tail = reinterpret_cast<unsigned*>(e->sq_ring + p.sq_off.tail);
    e->sq_mask = reinterpret_cast<unsigned*>(e->sq_ring + p.sq_off.ring_mask);
    e->sq_array = reinterpret_cast<unsigned*>(e->sq_ring + p.sq_off.array);
    e->cq_head = reinterpret_cast<unsigned*>(e->cq_ring + p.cq_off.head);
    e->cq_tail = reinterpret_cast<unsigned*>(e->cq_ring + p.cq_off.tail);
    e->cq_mask = reinterpret_cast<unsigned*>(e->cq_ring + p.cq_off.ring_mask);
    e->cqes = reinterpret_cast<io_uring_cqe*>(e->cq_ring + p.cq_off.cqes);
    e->ops.resize(p.sq_entries);
    return e;
}

long ds_aio_submit_read(void* h, const char* fname, void* buf, long nbytes,
                        long offset) {
    return submit(static_cast<Engine*>(h), fname, buf, nbytes, offset, false);
}

long ds_aio_submit_write(void* h, const char* fname, void* buf, long nbytes,
                         long offset) {
    return submit(static_cast<Engine*>(h), fname, buf, nbytes, offset, true);
}

long ds_aio_drain(void* h) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    while (e->inflight > 0) {
        if (sys_io_uring_enter(e->ring_fd, 0, 1, IORING_ENTER_GETEVENTS) < 0)
            return -errno;
        long r = reap(e);
        if (r < 0) { e->completed_total = 0; return r; }
    }
    long total = e->completed_total;
    e->completed_total = 0;
    return total;
}

long ds_aio_inflight(void* h) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    return e->inflight;
}

void ds_aio_destroy(void* h) {
    delete static_cast<Engine*>(h);
}

void* ds_alloc_pinned(long nbytes) {
    long rounded = ((nbytes + kAlign - 1) / kAlign) * kAlign;
    void* p = nullptr;
    if (posix_memalign(&p, kAlign, rounded) != 0) return nullptr;
    std::memset(p, 0, rounded);
    mlock(p, rounded);  // best-effort: RLIMIT_MEMLOCK may cap it
    return p;
}

void ds_free_pinned(void* p, long nbytes) {
    long rounded = ((nbytes + kAlign - 1) / kAlign) * kAlign;
    if (p) { munlock(p, rounded); free(p); }
}

// ---------------------------------------------------------------------
// blocking path (sync ops + fallback when io_uring is unavailable)
// ---------------------------------------------------------------------

long ds_pread(const char* filename, void* buffer, long nbytes, long offset,
              int use_direct) {
    int flags = O_RDONLY;
    if (use_direct && aligned(buffer, nbytes, offset)) flags |= O_DIRECT;
    int fd = open(filename, flags);
    if (fd < 0 && (flags & O_DIRECT)) fd = open(filename, O_RDONLY);
    if (fd < 0) return -1;
    long done = 0;
    char* p = static_cast<char*>(buffer);
    while (done < nbytes) {
        ssize_t r = pread(fd, p + done, nbytes - done, offset + done);
        if (r <= 0) break;
        done += r;
    }
    close(fd);
    return done;
}

long ds_pwrite(const char* filename, const void* buffer, long nbytes,
               long offset, int use_direct) {
    int flags = O_WRONLY | O_CREAT;
    if (use_direct && aligned(buffer, nbytes, offset)) flags |= O_DIRECT;
    int fd = open(filename, flags, 0644);
    if (fd < 0 && (flags & O_DIRECT)) fd = open(filename, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) return -1;
    long done = 0;
    const char* p = static_cast<const char*>(buffer);
    while (done < nbytes) {
        ssize_t w = pwrite(fd, p + done, nbytes - done, offset + done);
        if (w <= 0) break;
        done += w;
    }
    close(fd);
    return done;
}

}  // extern "C"
