/* Parallel file reader for .npy trajectory shards.
 *
 * Datasets are directories of large .npy shards. Reading them one after
 * another leaves disk bandwidth unused; this reader fills caller-allocated
 * buffers from many files at once on a pthread pool. It has a plain C
 * interface and is called through ctypes, which releases the GIL for the
 * call. Sizing the files, parsing the .npy headers and wrapping the buffers
 * as arrays stay in Python (shadowing_tpu_torch/native/__init__.py).
 *
 *   int read_files_parallel(const char **paths, char **bufs,
 *                           const size_t *sizes, int *errors,
 *                           int n, int n_threads)
 *
 * reads sizes[i] bytes of paths[i] into bufs[i] for every i < n, writes 0 or
 * the errno of the failure into errors[i], and returns the number of files
 * that failed (or -1 if no thread could be started).
 */
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stddef.h>
#include <sys/types.h>
#include <unistd.h>

typedef struct {
    const char **paths;
    char **bufs;
    const size_t *sizes;
    int *errors;
    int n;
    int next;         /* guarded by lock */
    pthread_mutex_t lock;
} TaskQueue;

static void *worker(void *arg)
{
    TaskQueue *q = (TaskQueue *)arg;
    for (;;) {
        pthread_mutex_lock(&q->lock);
        int i = q->next < q->n ? q->next++ : -1;
        pthread_mutex_unlock(&q->lock);
        if (i < 0)
            return NULL;

        int fd = open(q->paths[i], O_RDONLY);
        if (fd < 0) {
            q->errors[i] = errno;
            continue;
        }
#ifdef POSIX_FADV_SEQUENTIAL
        posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
        size_t done = 0;
        while (done < q->sizes[i]) {
            ssize_t got = pread(fd, q->bufs[i] + done, q->sizes[i] - done,
                                (off_t)done);
            if (got <= 0) {   /* a file shorter than it was sized is an error */
                q->errors[i] = got < 0 ? errno : EIO;
                break;
            }
            done += (size_t)got;
        }
        close(fd);
    }
}

int read_files_parallel(const char **paths, char **bufs, const size_t *sizes,
                        int *errors, int n, int n_threads)
{
    if (n_threads < 1)
        n_threads = 1;
    if (n_threads > 64)
        n_threads = 64;
    if (n_threads > n)
        n_threads = n;
    for (int i = 0; i < n; i++)
        errors[i] = 0;

    TaskQueue q = {paths, bufs, sizes, errors, n, 0,
                   PTHREAD_MUTEX_INITIALIZER};
    pthread_t threads[64];
    int started = 0;
    for (int t = 0; t < n_threads; t++)
        if (pthread_create(&threads[started], NULL, worker, &q) == 0)
            started++;
    for (int t = 0; t < started; t++)
        pthread_join(threads[t], NULL);
    if (n > 0 && started == 0)
        return -1;

    int failed = 0;
    for (int i = 0; i < n; i++)
        failed += errors[i] != 0;
    return failed;
}
